#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``smg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, needs one CUDA card
    python3 chip_smoke.py --phases kernels   # build + kernel checks only
    python3 chip_smoke.py --phases checkpoint   # build + kernels + phase 8 only
    python3 chip_smoke.py --phases moe   # build + kernels + phase 9 only
    python3 chip_smoke.py --phases api   # build + kernels + phase 10 only
    python3 chip_smoke.py --phases vision   # build + kernels + phase 12 only
    python3 chip_smoke.py --phases pd   # build + kernels + phase 13 only
    python3 chip_smoke.py --phases transfer   # build + kernels + phase 13 (c) only
    python3 chip_smoke.py --phases launch   # build + kernels + phase 14 only
    python3 chip_smoke.py --phases routing   # build + kernels + phase 14 (c) and (d) only
    python3 chip_smoke.py --phases mesh   # build + kernels + phase 14 (d) only
    python3 chip_smoke.py --phases responses   # build + kernels + phase 15 only
    python3 chip_smoke.py --phases messages   # build + kernels + phase 15's gateway, phase 16
    python3 chip_smoke.py --phases realtime   # build + kernels + phase 15's gateway, phase 17
    python3 chip_smoke.py --phases train   # build + kernels + phases 18 and 22 only
    python3 chip_smoke.py --phases breadth   # build + kernels + phase 12 (d) only
    python3 chip_smoke.py --phases dp   # build + kernels + phase 19 only
    python3 chip_smoke.py --phases tp   # build + kernels + phases 20-21 only

Phases (any failure makes the script exit non-zero and print no result):

1. print the card's ``nvidia-smi`` name and power limit, build the kernels
   from ``smg_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, in bf16,
   at the serving path's shapes (Llama-3-8B heads: 32 query / 8 KV heads,
   head_dim 128, page size 16) and at the edges of the decode split (split
   boundaries, a window across two splits, a padded row alone), plus
   head_dim 64 (G=1), 256 (G=2, Gemma-2-9B) and the padded 96 (G=1,
   Phi-3-mini) and 80 (G=4), Qwen3-30B-A3B's 32 query over 4 KV heads
   (G=8, head_dim 128) and Qwen2-VL-7B's 28 over 4 (G=7: a group that
   does not divide 64); then time kernel, plain
   version and one PyTorch library call computing the same function (SDPA
   on gathered K/V, a yardstick the port never calls) at the timed shapes:
   decode B=32 ragged, B=4 x ~1000 with n_extra 4 (the serving shape) and
   B=1 x 8000; prefill T=512 over a 1000-token prefix and a cold grouped
   prefill of 8 rows; the same decode B=32, B=4 and prefill cases again at
   G=8, and at G=7 with B=1 x 8000 too;
3. serve requests on Llama-3-8B at full width and depth (random bf16
   weights from a fixed seed, bf16 KV): a chunked long prompt, a radix
   prefix hit, decode horizon 4, submitted from the main thread with
   ``on_output`` callbacks.  Three paths in turn: the serving path (decode
   megasteps replayed from CUDA graphs, the overlap pipeline, the engine's
   loop thread via ``engine.start()``), the eager synchronous path on the
   same kernels (``decode_graphs=False``, ``overlap_schedule=False``,
   stepped from the main thread), and the plain attention versions (eager,
   synchronous).  Kernel launch counts must equal what the schedule
   implies (32 layers x decode columns, counted through graph replays; 32
   x prefill forward calls) and every run's ``audit()`` must be clean;
   decode is profiled on 4 lanes per path.  Every engine is built under
   the lock-order sentinel, which must record no inversion.  On the
   serving path, after its profile, 4 new lanes decode past their
   64-page table's end, the graph auditor is armed, and 16 megasteps run
   unguarded, then 16 inside ``steady_state_guard`` (the sync debug mode
   "error", process-wide): no capture, no kernel build, no step failure
   (a host sync on the loop thread), ``program_audit`` clean, and
   ``.item()`` on a device tensor under the guard raises; both windows'
   ms per decode column are printed beside the profiled window's.  All three again on the first
   ``F32_LAYERS`` (4) layers of the same weights, full width, widened to
   float32 with float32 KV, where the greedy streams must be identical and
   which is the reference the bf16 runs of that depth's first-token logits
   are held to (the float32 repeats of phases 4, 5, 7, 8 and 10 on these
   weights run at that depth too: their checks are exact at any depth,
   and the depth keeps the script inside its deadline; phase 6's runs
   last, on all 32 layers widened in place).  Then preemption: 4 layers,
   float32, a page pool too small for four requests, streams equal to a
   roomy run and no page leaked;
4. request semantics, on the first ``BF16_REPEAT_LAYERS`` (8) layers of the
   same weights in bf16 and then in float32,
   through the same three paths: six requests with a synthetic tokenizer
   at the full vocabulary (``PieceTokenizer``): greedy with frequency and
   presence penalties, greedy with a repetition penalty, sampled with a
   frequency penalty, greedy with a stop string (the text of tokens 10-12
   of the same prompt's unconstrained greedy run), greedy under a regex,
   sampled under the JSON grammar.  Each must finish with its expected
   count and reason, the stop request's text must end where its stop
   string began, the regex and JSON texts must be valid (complete and
   parsable when they stopped), launch counts and audits as in phase 3;
   in float32 the greedy streams must be identical across the paths.
   Readings on the graph path: host ms per grammar mask (each dtype); in
   bf16 the penalty work alone, decode on 4 lanes with and without
   penalties, and a window held at horizon 1 by a stop-string lane;
5. the serving entry, after phase 4 on each dtype's weights: the port's
   gateway (``cache_aware``, one in-process worker over an engine with
   phase 3's settings, graphs, overlap and the loop thread) on a free local
   port, with ``MockTokenizer`` at the full vocabulary; every request sent
   with ``urllib``: probes, a greedy 32-token chat and the same chat
   streamed (deltas, finish, usage, ``[DONE]``), a 1400-token prompt
   through ``/v1/completions`` and ``/generate`` (three prefill chunks), a
   shared 600-token prefix (the second request's cached tokens), eight
   concurrent streams (TTFT, gaps between SSE frames, the device's busy
   share; ``/scheduler``'s audit after), a poisoned prefill among three
   (finish ``error``) and a decode fault in a 4-lane batch (the newest lane
   quarantined), the flight dump and ``/metrics``; the engine and the
   gateway are built and served under the lock-order sentinel (no
   inversion), and ``cache_aware`` must route over the native radix tree
   (a failed build of the index fails the phase).  Each request is also
   submitted to the engine directly: in float32 the HTTP path's tokens
   must equal those, in bf16 the agreement is printed, with the direct
   path's TTFT and gaps beside the HTTP ones.  Kernel launches through the
   HTTP path must equal the schedule's;
6. the request-policy layer over HTTP, after phase 5 in bf16 and after
   phase 10 in float32, always at full depth (its ``/debug/slo`` check is
   relative, and a shallow model's short TTFT leaves host latencies of a
   few ms too large a share of it), with phase 5's engine settings: one
   engine behind seven
   gateways built from ``serve`` flags (bare; every layer on: an API key,
   a rate limit, priority admission, a request timeout, CORS, SLO specs,
   OTel export to an in-process collector; a burst-2 rate limit; one
   priority slot; a 1 s timeout; ``--reasoning-parser qwen3``;
   ``--harmony on``).  Checks: 401/403 without or with a wrong key and the
   lone chat's tokens with it; one 429 of three concurrent chats and
   nothing left in flight; a 200-token ``bulk`` chat preempted by a
   ``system`` chat, aborted in the engine, rerun to its lone run's tokens
   (exact in float32), the system chat first, ``audit()`` clean and every
   page back; a 1000-token decode cut at 1 s (408, and a streamed one cut
   without ``[DONE]``), ended once each in the engine; a tool call,
   ``reasoning_content`` and harmony channels through the engine with a
   scripted tokenizer (``ScriptTokenizer``), streamed and not; the eight
   concurrent streams through the bare and the full gateway in turns,
   ``/debug/slo``'s TTFT and per-token ITL p50s within 5% of the client's
   (TTFT from dispatch, as the SLO's runs: each request's own front door,
   read from its spans, comes off the client's; the back door, from the
   router's first chunk to the client's first frame, is printed beside);
   one SLO spec passing and one failing; the span tree of a chat sent with
   a ``traceparent``; exact launches.  Readings: the gateway's cost per
   token with every layer on against the bare gateway and direct
   callbacks, the lone chat's added TTFT, the preemption latency;
7. speculative decoding, after phase 6 on each dtype's weights (in bf16 the
   first ``BF16_REPEAT_LAYERS`` layers, as phase 4), with
   phase 3's engine settings plus ``speculative=True`` (8 drafts, a 9-wide
   verify block): four concurrent 32-token requests (greedy on a
   1000-token repeated prompt, greedy on a plain prompt, temperature 0.8
   on a repeated prompt, a stop-string lane) through the n-gram tier on
   the serving path, the same with overlap off, the eager synchronous path
   and the serving path without speculation; then the same requests
   through the draft tier on the serving path: a ``DraftRunner`` over the
   target's own weights, and Llama-3.2-1B at random bf16 weights with
   overlap on and off.  A model with random weights copies nothing from
   its context, so the n-gram tier drafts only by chance there.  Checks:
   every lane but the stop lane drafts in the draft tiers; in float32
   every greedy stream equals the non-speculative run's and the graph and
   eager streams agree, and the self-draft tier accepts at least 90% of
   its greedy drafts; in both dtypes the sampled stream is identical with
   overlap on and off, the stop-string lane never rides a verify block,
   kernel launches equal the schedule (layers x rest-lane decode columns;
   layers x target prefill calls plus the draft's layers x its prefill
   calls) and
   every audit is clean.  Readings: ms per emitted token and tokens/s per
   tier against the non-speculative run, acceptance per tier, the verify
   block's device ms at W = 9 against one decode column (and profiled by
   kernel), and the verify graphs' capture seconds and bytes;
8. an HF checkpoint directory, after phase 7 on each dtype's weights.  In
   a temporary directory the script writes phase 3's bf16 weights as a
   Llama-3-8B HF checkpoint (``config.json`` with the published fields,
   ``[out, in]`` linears in 4 safetensors files with an index; the depth is
   cut only if the disk cannot hold it), a ``tokenizer.json`` built with
   ``tokenizers`` (128256 ids, Llama-3's special-token names at
   128000-128255) with a Llama-3-style chat template, two rank-16 PEFT
   adapters on q/k/v/o and a tiny directory at the full vocabulary.  Then,
   in bf16 and in float32 (the bf16 files widened as they load): (a)
   ``serve --model-path`` (built as the command line builds it, the load
   timed) behind the gateway: the loaded tensors equal phase 3's bitwise,
   the gateway's prompt ids equal ``tokenizers``' encoding of the template
   rendered by jinja2 alone, the chats (a short one, streamed too, and a
   1400-token one) equal the preset engine's on the same weights (exact in
   float32); (b) both adapters load through ``/load_lora_adapter`` and
   ``/list_lora_adapters`` lists them; (d) unloading or replacing an
   adapter with a live request is refused, then the unload succeeds and the
   next load takes the freed slot; the gateway's tokenize of a 1400-token
   chat with an L1 hit and a miss; (c) a batch of base, B, A and a chunked
   1400-token A lane (the first three in one grouped prefill) through the
   three paths of phase 3, with launches exact and audits clean: in float32
   the streams are identical across the paths, the base lane equals a
   base-only run (its logits bitwise, both dtypes), each adapter lane's
   first-token logits are within ``MERGED_F32_ATOL`` of an engine with the
   adapter merged into its weights (bf16: nearer those than the base
   model's); in bf16, decode of 4 LoRA lanes against 4 base lanes profiled.
   In float32, ``serve --speculative --model-path --draft-model-path`` on
   the tiny directory serves in a process of its own;
9. the Qwen-MoE family on Qwen3-30B-A3B (the published config: 48 layers,
   128 experts, top 8, 32 query over 4 KV heads, ``qk_norm``), after every
   earlier engine is released (at most ``MOE_LEFT_BYTES`` still
   allocated): (a) the full model at full width and depth, random bf16
   weights from seed 0 made on the card (61,064,245,248 bytes), KV
   auto-sized after the expert layer's reserve (the pages printed), phase
   3's five requests through the serving and the eager path (the plain one
   runs in (b), where its logits are the reference), launches exact at 48 x
   decode columns and 48 x prefill calls, audits clean; readings: init
   seconds, the 1400-token prompt's TTFT and chunked prefill device ms
   against dense dispatch's operations bound, the prefill's peak memory,
   decode device ms a column on 4 lanes, its busy share and its op classes
   (expert products, router and top-k, the combine, attention kernels, the
   rest: from the eager path's trace, with the expert layer's steps in
   profiler ranges) against two bounds (every expert's bytes; only the
   experts that column routed to, counted on the device), tokens/s; (c) the
   expert layer of one layer at T=512 and B=4 against a gathered per-token
   top-8 computation in float32 (float32 and bf16), timed; (b) the first
   ``MOE_F32_LAYERS`` layers (kept on the host while the full model goes)
   through the three paths in bf16 and widened to float32: float32 streams
   identical, logits within ``F32_LOGIT_ATOL``, bf16 first-token logits held
   to float32's by mean row rms, the kernel paths at most
   ``BF16_ERR_RATIO`` times as far as the plain one; (d) those weights'
   first ``MOE_CKPT_LAYERS`` layers written as a Qwen3-MoE HF directory
   (the published ``config.json`` at that depth, every expert's linears as
   tensors of their own, a word-level ``tokenizer.json`` of 151936 ids with
   Qwen's special tokens and a ChatML template) and served with ``serve
   --model-path`` in bf16 and float32: loaded tensors bitwise the in-memory
   ones, HTTP chats equal to a direct engine's tokens (exact in float32);
10. the rest of ``serve``, embeddings, rerank and classify, on phase 3's
   weights in bf16 (after phase 8) and widened to float32 (before phase 9
   releases them): phase 3's five requests on the graph path under
   ``prefill_mix_policy="throughput"`` and with the prefix cache off
   (launches exact, audits clean, no prefix hit with the cache off, in
   float32 the streams identical to stall-free's; readings: the 1400-token
   prompt's TTFT and, in bf16, decode device ms a column on 4 lanes under
   both policies); then two gateways built from ``serve`` flags over an
   engine with graphs, overlap and the loop thread: ``/v1/embeddings`` of 8
   texts of 200-1500 tokens and of two id lists (one at the 4096-token
   cap), bitwise a direct ``engine.embed``, unit rows, within
   ``EMBED_F32_ATOL`` of the forward in one tile in float32 and the bf16
   rows held to the float32 ones by row rms (``EMBED_BF16_REL``); embed
   device ms of the 8 rows and of the 4096-token row against their
   operations bound and their peak memory above the resident (beside the
   live KV cache); ``/v1/rerank`` with ``top_n`` and ``/v1/classify``
   against direct cosines; ``/debug/router``'s shared-prefix decision
   (reconciled, a prefix hit) and the request id from
   ``--request-id-headers``; ``/debug/kv_index`` equal to the worker's
   ``loads()``; ``/start_profile`` then ``/stop_profile`` writing a trace
   with CUDA kernel events; on a round-robin gateway over two engines with
   ``--cb-failure-threshold 1``, a stream that dies mid-decode opens one
   breaker, later chats go around it, a probe after
   ``--cb-timeout-duration-secs`` closes it, and a body over
   ``--max-payload-size`` is refused.  In bf16 last: ``FAULT_ENGINES``
   engines with graphs built, served and dropped in a row grow
   ``memory_allocated`` by 0 bytes after the second, and an engine that
   outlives another replays its graphs bitwise;
12. Qwen2-VL-7B-Instruct (its published config by value; 28 layers at
   width 3584, 28 query over 4 KV heads, M-RoPE sections [16, 24, 24], a
   tower of 32 layers at width 1280; random bf16 weights from a seed, 16.6
   GB) after phase 9: the tower in float32 at 2 layers on the card against
   the CPU, and in bf16 at full depth timed against its operations bound
   with its peak memory, for a 448 x 448 image (1024 patches, 256 tokens)
   and one at the processor's ``max_pixels`` (5120 patches, 1280 tokens);
   two image requests, one with two images and a text request in one batch
   through the graph path at full depth (auto-sized KV after the vision
   reserve, launches exact at 28 x decode columns and 28 x prefill calls,
   audits clean), the same image again sharing KV and another image behind
   the same ids sharing none, the decode column of 4 image lanes against 4
   text lanes, the 1280-token image request's TTFT split into encode and
   prefill, and one image chat over HTTP (a PNG data URI) equal to the same
   pipeline driven directly, and the same message through ``/v1/messages``
   with the image as an Anthropic base64 ``source`` block: its greedy text
   equal to the chat's, stop reason ``max_tokens``, the same prompt tokens;
   then the first 4 layers through the three
   paths in float32 (greedy streams identical, the text request equal to
   itself alone) and the graph and plain paths in bf16, held to the
   float32 run as in phase 3.  (d), on (b)'s engine before its chat: the
   ten image processors with the worker's geometry on the card against
   the CPU over seeded 768 x 1024, 900 x 200 and 64 x 64 images (geometry
   exact, pixels within ``BREADTH_PIXEL_ATOL``, card ms printed); an image
   chat for InternVL, Gemma 3, Phi-3-vision, Kimi-K2.5 and Qwen3-Omni model
   names (the engine registered under each) returning 200 with the
   encode's rows equal to the placeholders and ``prompt_tokens`` the
   text's plus the placeholders (encode ms and TTFT printed); LLaVA,
   Pixtral and Llama 4 names getting the reference's 502 text; an 8-frame
   GIF through ``VideoProcessor`` on the card against the CPU;
13. PD disaggregation, after phase 10 on phase 3's bf16 weights: a PREFILL
   and a DECODE engine behind the port's gateway (``--kv-connector auto``
   and ``host``, two gateways over the same engines) against a co-located
   engine behind its own, every engine's KV sized by hand (two or three
   engines share the card).  (a) The first ``PD_LAYERS`` layers widened
   to float32: the 1400-token chat's export on each connector (the device
   payload a CUDA tensor on the card, the host one in host memory, every
   prefill page back), imported by the decode engine into graphs it
   captured before the import (no new capture) and by an eager engine:
   tokens equal the co-located engine's, logprobs within 1e-4; through the
   gateways the lone chat and 8 concurrent chats equal the co-located
   gateway's, ``auto`` imports on the card and ``host`` through the host,
   the decode engine prefills nothing, while the decode engine captures
   its new batch shapes as the prefill engine exports (both loop threads
   live, the capture stream shared); audits clean after the drain.  (b)
   bf16 at full depth: the lone chat equal on both connectors; the PD
   path's kernel launches exact (32 x prefill calls on the prefill engine,
   32 x decode columns on the decode engine); readings: the 1400-token
   handoff (88 pages) per connector against its bytes bound (device: CUDA
   events; host: wall time, bounded by the pinned copy rates measured
   here), TTFT through the gateway PD against co-located, the decode
   engine's device ms a column on 4 lanes adopted through PD against phase
   3's.  (c) Two processes (this script with ``--pd-worker``) each serve a
   4-layer float32 engine at full width with ``rpc.server.serve_worker``,
   behind two gateways through ``GrpcWorkerClient`` as PREFILL and DECODE:
   ``auto``, which picks ``transfer`` (the decode worker pulls the KV from
   the prefill worker's offer device to device, CUDA IPC), and ``host``;
   on both the lone and the 8 concurrent chats equal the in-process
   ``host`` PD's; this process pulls an offer of the lone prompt by
   (address, uuid), bitwise the ``host`` export of the same prompt;
   readings: the transfer and the host leg (wall) and the pull alone, each
   beside its bytes bound; at exit each worker reports its kernel launches
   (4 x decode columns, 4 x prefill calls) and its transfer counts (every
   offer served or pulled, none pending or reclaimed); then ``python -m
   smg_tpu_torch.cli worker`` (tiny preset) answers ``HealthCheck`` and
   exits 0 on SIGTERM.  ``--phases transfer`` runs (c) alone;
14. ``launch``, after phase 12, with the command line's own processes
   (``python -m smg_tpu_torch.cli launch|serve|worker``); full-depth
   processes run one at a time, each sizing its KV to most of the card.
   (a) ``worker --model-preset llama3-8b`` (full width and depth, random
   bf16 weights from seed 0, phase 5's engine settings) behind ``launch
   --worker 127.0.0.1:P`` with no tokenizer flag: ``/workers`` lists it
   with its model id, ``/workflows/{id}`` reports the startup registration
   completed with the tokenizer fetched, the gateway's ids are the
   worker's, and the lone 1400-word chat, streamed and not, gives the
   tokens and text of ``serve``'s engine from the same flags in this
   process; readings against that in-process gateway: the seconds from the
   worker's spawn to its registration, the lone chat's TTFT and gap per
   token, the median TTFT of 8 concurrent streams.  (b) a ``serve``
   process behind ``launch --worker http://127.0.0.1:S``: chat and
   completions, streamed and not, through ``launch`` give the bodies and
   SSE frames of the same requests sent straight to ``serve`` (ids and
   times removed); reading: the TTFT the proxy hop adds.  (c) two of this
   script's own worker processes (``--pd-worker``: 4 layers, float32, KV
   pages sized by hand) behind a bare ``launch``: ``POST /workers``
   synchronous and ``"async": true`` (202, then the job), a registration
   against a port nothing listens on yet that fails and resumes once the
   worker, loaded meanwhile, takes that port (the PD ``launch`` and the
   gateways of the routing policies and of (d) start while it fails and
   register that worker then), ``DELETE /workers/{id}?drain=10`` during a stream
   (the stream finishes, a chat during the drain goes to the other
   worker), SIGTERM exiting 0; then ``launch --prefill-worker A
   --decode-worker B``: the lone and 8 concurrent chats equal the
   in-process PD's, each prompt's legs straight at the workers its tokens
   with logprobs within 1e-4; then one ``launch`` per routing policy over
   the same two workers: ``--policy prefix_hash --prefix-token-count 64``
   (8 chats in 2 families of a 300-token prefix: one worker per family,
   each family's later chats cached), ``--policy consistent_hashing`` (12
   prompts twice on the same workers; after one worker is drained only its
   prompts move), ``--policy cache_aware`` (``/debug/kv_index`` shows the
   native tree; a shared-prefix chat goes to the worker holding the
   prefix) and ``--dp-aware`` (each worker reports ``dp_size`` 1); each
   worker reports its kernel launches at exit, equal to 4 x its decode
   columns and 4 x its prefill calls, and the ``data_parallel_rank`` of
   every generate it received: all -1.  (d) The HA mesh, started with
   (c)'s four routing gateways: three ``launch --mesh-port`` processes
   (mutual TLS where the host has ``openssl``), G1 holding both workers,
   G2 and G3 seeded from G1 holding none: G2 and G3 list G1's workers, a
   chat through each gives G1's greedy text, 4 families of a 300-token
   prefix routed by ``cache_aware`` through G1 raise G2's
   ``smg_cache_inserted_prefixes`` by 4 and go to G1's workers through G2,
   a ``POST /workers`` on G2 reaches G1 and a removal on G1 leaves G2;
   after one SIGTERM to G3, G1 and G2 each log it dead within 20 gossip
   rounds (``gossip peer … marked dead`` where the gateway dialled it in
   vain, else the partition detector's ``unreachable=1`` where it heard of
   the death from its peer); every gateway exits 0.  ``--phases routing``
   runs (c) and (d) alone, ``--phases mesh`` (d) over its own two
   workers;
15. the Responses API, after phase 14: one in-process ``serve`` built by the
   command line's own ``_run_gateway`` (``--model-preset llama3-8b``: full
   width and depth, random bf16 weights from seed 0, phase 5's engine
   flags, the KV auto-sized; ``--storage sqlite:<tmp>/conv.db``;
   ``--mcp-config-path`` naming a small JSON-RPC MCP server this script runs
   on 127.0.0.1 with one tool, ``lookup``, that counts its calls).  (a)
   ``/v1/conversations``: create with items, get, list and add items,
   update the metadata, delete, a second delete 404.  (b) three greedy
   32-token turns chained by ``previous_response_id``, three times: each
   turn's text equals a direct chat of the same messages and tools (the
   radix cache flushed before every call), turn 3's usage equals its chat
   call's, the stored turn reads back and deletes.  (c) the same three
   turns through a ``conversation`` with the cache warm: the stored items
   are the inputs and outputs in order, kernel launches equal 32 x decode
   columns and 32 x prefill calls over exactly those turns, and turn 3's
   chat decision on ``/debug/router`` reports the prefix it reused.  (d) a
   streamed turn: the event names ``create_stream`` defines, in order, the
   deltas joining to the non-streamed text.  (e) an ``mcp_approval_request``
   item posted into a conversation and answered: approving runs the tool
   once on the script's server, the output holds its ``mcp_call`` and the
   model's turn equals a chat with the tool's answer; denying runs nothing
   and yields "approval denied by user"; an unknown key 404s.  (f)
   ``--storage nosuch://x`` fails startup with the reference's
   ``ValueError`` before any weights load, and a request-level ``mcp`` tool
   whose label collides with the configured server gets the reference's
   400.  Readings: wall ms per turn of ``/v1/responses`` against the direct
   chat (medians of 3, cold radix), turn 3's prompt and cached tokens, the
   MCP call's ms from the handler's call to the tool's answer;
16. the Anthropic Messages API, third-party providers and per-model
   routers, over phase 15's gateway and engine (no second load), every
   request greedy from a cold prefix cache and its kernel launches counted
   over the whole phase (32 x decode columns, 32 x prefill calls).  (a)
   ``/v1/messages`` with a system prompt and user, assistant and user turns
   (32 tokens at temperature 0), unstreamed and streamed: the text of
   ``/v1/chat/completions`` on the same messages exactly, ``usage`` equal
   to the chat's, stop reason ``max_tokens``, the events in the bridge's
   grammar (``message_start``, ``content_block_start``,
   ``content_block_delta``..., ``content_block_stop``, ``message_delta``,
   ``message_stop``) with the text deltas joining to the text.  (b) a
   ``launch --provider-config`` process with no worker, started before
   phase 15's engine loads, with three providers (``openai``,
   ``anthropic``, ``xai``) all pointing at phase 15's gateway: its
   ``/v1/models`` lists them; chat through each, streamed and not, and
   ``/v1/messages`` over ``openai`` (the bridge), streamed and not, give
   (a)'s text (the ``anthropic`` provider posting to the gateway's own
   ``/v1/messages``); ``/v1/responses`` over ``xai`` (upstream, where the
   handler adds the MCP tool) equals a chat with that tool, and over
   ``openai`` (the chat adapter) a chat without it.  (c) ``POST
   /models/<model>/router`` with an unknown field is a 400 that leaves
   ``/routers`` as it was; with ``default_max_tokens`` 16 the chat gives
   (a)'s text and a chat with no budget 16 tokens; ``/routers`` shows the
   dedicated router, ``DELETE`` restores the default.  (d) readings, not
   claims: lone TTFT and wall ms (16 tokens, medians of 5) of the direct
   chat, ``/v1/messages``, chat through each provider hop and
   ``/v1/messages`` through the ``openai`` hop; the host ms the bridge
   spends per ``/v1/messages`` request; the phase's seconds;
17. the Realtime, Interactions and transcription APIs and plugins, over
   phase 15's gateway and engine (no second load; phase 15's ``serve``
   carries ``--plugins`` with this script's plugin, phase 16's front
   ``--plugins ... --plugin-fail-closed``), every turn 16 greedy tokens
   from a cold prefix cache, kernel launches counted over the whole phase
   (32 x decode columns, 32 x prefill calls).  (a) a ``/v1/realtime``
   session: ``session.update`` (temperature 0), two turns of
   ``conversation.item.create`` + ``response.create`` in the reference's
   event order, the deltas joining to ``response.done``'s text, each turn's
   text the direct chat's on the same history exactly; an unknown event
   gets the ``error`` event and the session goes on.  (b) a loopback ASR
   server (a thread of this process) registered through ``POST /workers``:
   three base64 PCM16 frames appended and committed reach it as
   ``pcm16_to_wav`` of the frames (SHA-256), the transcript event carries
   its transcript and the response on it equals the direct chat on it;
   ``/v1/audio/transcriptions`` with two ``timestamp_granularities[]``
   parts reaches it in ``json`` (its hash echoed) and ``text``.  (c) an
   extra in-process gateway over the same engine with an API key and
   ``--request-timeout-secs 1``: a handshake with no credential gets the
   ``authentication_error`` event, minting needs the key, a session over
   ``?client_secret=`` outlives the timeout and answers (a)'s first turn,
   relay legs exchange a text and a 64 KiB binary frame byte for byte past
   it, and a long chat still gets its 408.  (d) ``/v1/interactions``: a
   stored turn and a ``previous_interaction_id`` turn equal the direct
   chats, the chained turn streamed joins its ``content_delta``s to its
   text, ``GET``, ``DELETE``, 404 after, and a ``/v1/responses`` id is 404
   there.  (e) the plugin (``x-smoke-plugin`` header): ``reject`` a 451
   ``plugin_rejected`` on both, ``tag`` a response header with the same
   text, ``fault`` answered fail-open by ``serve`` and 500 by the
   fail-closed front; no header, no change.  Readings: realtime TTFT to the
   first delta against the direct chat's, an interactions turn's wall ms
   against its chat's (medians of 5), the plugin host's ms per request for
   both hooks, the phase's seconds;
18. the training step, after phase 17, in a process of its own (this
   script with ``--train-worker``) started once this one has given the card
   back, on phase 3's weights made again from seed 0.  (b) Their first
   ``F32_LAYERS`` layers widened to float32 with float32 KV: a prompt
   sharing a 600-token prefix with an earlier request, served greedily
   with phase 3's engine settings (decode graphs, overlap, horizon 4):
   a radix hit, then two prefill chunks, 16 tokens; ``forward_train`` over
   the prompt and the stream gives the prefill's last logits within
   ``F32_LOGIT_ATOL``, every greedy token, and every logprob the engine
   reports within 1e-4; launches exact (4 x decode columns, 4 x prefill
   calls), audit clean.  (a) ``make_train_step`` on all 32 layers in bf16
   (the deepest that fits the card's free memory, by a printed reckoning,
   if not all do): 8 AdamW steps on one batch of B=1, T=512; loss and
   ``grad_norm`` finite at every step, the last loss below the first,
   ``state.step`` 8.  Readings: ms a step (median of steps 2-7, split at
   the optimizer by CUDA events), tokens/s, peak ``max_memory_allocated``,
   against the step's bound (operations at the bf16 peak plus AdamW's and
   the norm's bytes at the HBM rate); step 8 under ``torch.profiler``: the
   device's busy ms by kernel class against the step's ms.  (c) 3 float32 steps of the tiny
   config on the card and on the CPU from the same weights: loss and
   ``grad_norm`` within 1e-5 relative, parameters as in
   ``tests/test_torch_train.py``.  Then, in the same process, phase 22;
19. data-parallel replicas, in a process of its own: phase 13 (c)'s
   worker weights (4 layers, float32) shared by two engines served by one
   ``serve_worker_async(engines=[e0, e1])`` and a third served alone, each
   KV pool 2048 pages by hand.  ``dp_size`` 2; greedy streams pinned to
   ranks 0 and 1 equal the one-engine worker's, each admitted on its own
   replica (read on the replicas' prompt counters); beside a long stream
   on rank 0 a -1 request lands on rank 1 and ``GetLoads`` gives two
   ``dp_queued_tokens``, the busy one queued; rank 2 gets the reference's
   error text; an abort of a rank-1 stream leaves no page held there; four
   concurrent streams through an in-process ``launch --dp-aware`` reach
   ranks 0 and 1, through ``--no-dp-aware`` all -1; every page back on
   every engine and launches exact.  Readings: each replica's decode
   column on 4 lanes alone and with the other decoding;
20-21. rank meshes, in a process of its own: first a probe of
   whether NCCL accepts two ranks on ``cuda:0`` (printed; refused, the
   ranks share the card over gloo collectives and decode eagerly).  (a)
   Llama-3-8B at full width, ``F32_LAYERS`` layers, float32, weights from
   one seed, a prefill budget of 1024: tp=2, pp=2, pp=2 x tp=2 and sp=2
   engines' greedy streams (phase 3's requests: a chunked long prompt, a
   radix hit, horizon 4, the loop thread with overlap) equal a tp=1
   engine's, their first-token logits are within ``F32_LOGIT_ATOL`` and
   each rank's launches equal its layers x its schedule; sp=2 rings the
   long prompt's cold 1024-token first chunk (the runner's prefill keys);
   (b) all 32 layers in bf16, 4 lanes of 16 tokens through tp=2, then
   pp=2: each rank's kernel launches equal its layers (32 a tp rank, 16 a
   stage) x its decode columns and x its prefill calls, audit clean.
   Readings: ms a decode column beside a tp=1 engine's on the same eager
   path, bytes resident per rank and per stage.  (c) the ring over two sp
   rank threads against the prefill kernel on one bf16 chunk of 1024
   tokens, held with phase 2's tolerance.  (d) Qwen3-30B-A3B at full width:
   ep=2 in float32 at ``F32_LAYERS`` layers equal to ep=1, then bf16 at
   the greatest depth whose two ranks fit the free card (printed with the
   bytes a rank), launches exact per rank.  (e) ``serve --tp 2`` and
   ``serve --pp 2`` with no device list exit non-zero with "needs 2
   devices, found 1"; (f) no rank process is left;
22. the sharded training step, in phase 18's process once phase 18 is
   done, every rank on ``cuda:0`` (gloo, and CUDA IPC for the sums); every
   mesh's followers lent by one ``RankPool`` of three processes forked
   from a fork server the process starts first.  (a) Llama-3-8B at full
   width, ``MESH_TRAIN_LAYERS`` layers, float32, B=4, T=512, weights from
   seed 0, a loss mask with holes: the one-device step, then dp=2, tp=2,
   sp=2 (the training ring), pp=2 (4 microbatches) and dp=2 x tp=2, one
   after another, ``MESH_TRAIN_STEPS`` steps each: loss and ``grad_norm``
   within 1e-5 relative of the one device's at every step, every leaf's
   ``mu`` and ``nu`` norm within 1e-4 (assembled from the ranks' sums of
   squares); Qwen3-30B-A3B at full width, one layer: ep=2 against ep=1
   alike.  (b) Llama-3-8B at 32 layers in bf16: tp=2 (B=1) and pp=2 (B=4,
   4 microbatches), a warm-up step and a timed one: the two losses finite,
   ms a step and each rank's peak device bytes, beside phase 18 (a)'s
   one-device step (the pool retired to one process first).  (c) no rank
   process left once the pool is closed;
Last, print ``{"kernels": [...]}`` (``launches`` from phase 5's bf16 HTTP
   run, ``launches_spec`` from phase 7's, ``launches_ckpt`` from phase 8's,
   ``launches_moe`` from phase 9's, ``launches_throughput`` from phase
   10's, ``launches_vision`` from phase 12's bf16 serving paths,
   ``launches_pd`` from phase 13's bf16 PD path, ``launches_transfer``
   from phase 13 (c)'s worker processes, ``launches_launch`` from phase
   14's worker processes, ``launches_responses`` from phase
   15's conversation turns, ``launches_messages`` from phase 16 and
   ``launches_realtime`` from phase 17, ``launches_train`` from phase 18
   (b), ``launches_breadth`` from phase 12 (d)'s family chats,
   ``launches_dp`` from phase 19's process, ``launches_tp`` from phase
   20 (b)'s two rank processes, summed, ``launches_pp``, ``launches_sp`` and
   ``launches_ep`` from phase 21 (b)'s stages, (a)'s sp ranks and (d)'s ep
   ranks, each summed) and, last, ``{"ok": true, "device": ...}`` (``--phases kernels``,
   ``checkpoint``, ``moe``, ``api``, ``vision``, ``pd``, ``transfer``,
   ``launch``, ``routing``, ``mesh``, ``responses``, ``messages``,
   ``realtime``, ``train``, ``breadth``, ``dp`` and ``tp`` print neither).

TF32 is off for matmuls and cuDNN, so float32 references stay float32.
Timings are medians of 15 repeats after warm-up: device time between CUDA
events, the L2 flushed before each repeat and the host's launch overhead
kept out (``cuda_ms``); each is also timed issued from an idle queue
(``call_ms``), host launch time included, as the port's first measurements
were.  The whole script takes a few minutes on an H100, the kernels'
build included.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import faulthandler
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
HANG_S = 1080  # the whole script's deadline (a run may take 1200 s)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# bf16 outputs of the same f32 arithmetic summed in another order: at most a
# couple of bf16 ulps (2^-7 relative) apart, plus an absolute term of 5% of
# the query row's rms (at most 2e-2).  An output over n keys has an rms near
# sqrt(e / n): over thousands of keys a fixed 2e-2 would be as large as the
# values, and would pass a decode split that was dropped or weighed wrong.
KERNEL_RMS_ATOL, KERNEL_MAX_ATOL, KERNEL_RTOL = 0.05, 2e-2, 1.6e-2
# first-token logits at full depth.  In float32 kernel and plain attention
# differ only in summation order: held to 2e-3 absolute, and the greedy
# streams must be identical.  In bf16 each run rounds its attention output
# to bf16 in other places and 32 layers carry that on, so the two are not
# held to each other but to the float32 run on the same (bf16-valued)
# weights: the kernel's bf16 logits may be at most twice as far from it as
# the plain version's.
F32_LOGIT_ATOL = 2e-3
BF16_ERR_RATIO = 2.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median CUDA-event time of one call issued from an idle queue, in
    milliseconds: the device time plus whatever host time the call spends
    before its first kernel starts."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_L2_FLUSH = []  # a buffer larger than the H100's 50 MB L2


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median device time of one call, in milliseconds, with a cold L2.

    A spin kernel holds the stream while the host enqueues every repeat
    (an L2 flush, a start event, the call, an end event), so each event
    pair brackets device work only, not the host's launch overhead.  The
    flush reads 128 MB, so it leaves clean lines and no write-back."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(32 << 20, dtype=torch.float32, device="cuda"))
    flush = _L2_FLUSH[0]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.sum()
    fn()
    host_s = time.perf_counter() - t0  # enqueue time of one repeat
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    # ~2e9 spin cycles a second; twice the host's enqueue time, and 2 ms more
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 2e-3)))
    for a, b in ev:
        flush.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---- phase 2: kernels against their plain versions ----

H, K, D, PS = 32, 8, 128, 16  # Llama-3-8B attention shapes
SHAPES = {  # (query heads, KV heads, head_dim) of the correctness-only cases
    "llama3": (H, K, D),
    "d64_g1": (12, 12, 64),  # multi-head attention at head_dim 64
    "d256_g2": (16, 8, 256),  # Gemma-2-9B
    # head dims the bf16 kernels pad to 128
    "d96_g1": (32, 32, 96),  # Phi-3-mini
    "d80_g4": (32, 8, 80),
    "qwen3_moe": (32, 4, 128),  # Qwen3-30B-A3B: G=8, the decode kernel's full head group
    # Qwen2-VL-7B: G=7, a group that does not divide 64 (the decode kernel
    # masks the eighth head of its group; the prefill kernel packs 9 tokens
    # a block, 63 live rows and one dead)
    "qwen2_vl": (28, 4, 128),
}


def rank_shape() -> tuple:
    """(query heads, KV heads, head_dim) of one rank of phase 20's tp
    engine: Llama-3-8B over ``TP_SIZE`` ranks (16 over 4 at tp=2: G=4,
    ``K*D`` = 512)."""
    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.parallel.sharding import rank_config

    rc = rank_config(llama3_8b_config(), TP_SIZE)
    return rc.num_heads, rc.num_kv_heads, rc.head_dim


def _cache(L: int, P: int, KD: int, gen, dev):
    import torch

    k = torch.randn((L, P, PS, KD), generator=gen, device=dev).bfloat16()
    v = torch.randn((L, P, PS, KD), generator=gen, device=dev).bfloat16()
    return k, v


def decode_case(B, entries, N, n_extra, softcap, window, gen, dev, pad_row=False,
                shape=(H, K, D)):
    """Decode inputs: ragged entries, distinct pages per row; with
    ``pad_row`` the last row is decode-bucket padding (entry = mp*ps)."""
    import torch

    h, k, d = shape
    mp = math.ceil(max(entries) / PS) + 1
    if pad_row:
        entries = list(entries[:-1]) + [mp * PS]
    P = B * mp + 1
    kc, vc = _cache(2, P, k * d, gen, dev)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[: B * mp] + 1).reshape(B, mp)
    return dict(
        q=torch.randn((B, h, d), generator=gen, device=dev).bfloat16(),
        k_cache=kc, v_cache=vc,
        hk=torch.randn((B, N, k * d), generator=gen, device=dev).bfloat16(),
        hv=torch.randn((B, N, k * d), generator=gen, device=dev).bfloat16(),
        n_extra=n_extra, layer=1, page_tables=pt.int().contiguous(),
        entry_positions=torch.tensor(entries, dtype=torch.int32, device=dev),
        scale=1.0 / math.sqrt(d), softcap=softcap, window=window,
    )


def decode_work(c) -> tuple[float, float]:
    """(bytes, flops) this run's data needs: each attended K/V row read once."""
    mp = c["page_tables"].shape[1]
    B, h, d = c["q"].shape
    kd = c["k_cache"].shape[-1]
    tokens = 0
    for e in c["entry_positions"].tolist():
        end = 0 if e >= mp * PS else e
        qpos = e + c["n_extra"] - 1
        lo = max(qpos - c["window"] + 1, 0) if c["window"] else 0
        tokens += max(end - lo, 0) + sum(1 for r in range(c["n_extra"]) if e + r >= lo)
    nbytes = tokens * kd * 2 * 2 + 2 * B * h * d * 2 + B * (mp + 1) * 4
    return nbytes, 4.0 * tokens * h * d


def prefill_case(T, prefixes, t_reals, softcap, window, gen, dev, shape=(H, K, D)):
    """Prefill inputs for len(prefixes) sequences; the chunk is scattered
    into the cache first, as the model does, so the plain version (which
    gathers the context from the cache) and the kernel see the same K/V."""
    import torch

    h, k, d = shape
    Gs = len(prefixes)
    mp = math.ceil((max(prefixes) + T) / PS) + 1
    P = Gs * mp + 1
    kc, vc = _cache(2, P, k * d, gen, dev)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[: Gs * mp] + 1).reshape(Gs, mp)
    ck = torch.randn((Gs, T, k * d), generator=gen, device=dev).bfloat16()
    cv = torch.randn((Gs, T, k * d), generator=gen, device=dev).bfloat16()
    for g in range(Gs):
        pos = prefixes[g] + torch.arange(t_reals[g], device=dev)
        pages = pt[g, pos // PS].long()
        kc[1, pages, pos % PS] = ck[g, : t_reals[g]]
        vc[1, pages, pos % PS] = cv[g, : t_reals[g]]
    return dict(
        q=torch.randn((Gs, T, h, d), generator=gen, device=dev).bfloat16(),
        chunk_k=ck, chunk_v=cv, k_cache=kc, v_cache=vc, layer=1,
        page_tables=pt.int().contiguous(),
        prefix_lens=torch.tensor(prefixes, dtype=torch.int32, device=dev),
        t_reals=torch.tensor(t_reals, dtype=torch.int32, device=dev),
        scale=1.0 / math.sqrt(d), softcap=softcap, window=window,
    )


def prefill_work(c) -> tuple[float, float]:
    _, _, h, d = c["q"].shape
    kd = c["k_cache"].shape[-1]
    keys = rows = prefix_rows = 0
    w = c["window"] or 0
    for p, tr in zip(c["prefix_lens"].tolist(), c["t_reals"].tolist()):
        rows += tr
        lo_min = max(p - w + 1, 0) if w > 0 else 0
        prefix_rows += p - min(lo_min, p)
        for t in range(tr):
            lo = max(p + t - w + 1, 0) if w > 0 else 0
            keys += (p - min(lo, p)) + (t + 1 - max(lo - p, 0))
    nbytes = (prefix_rows + rows) * kd * 2 * 2 + 2 * rows * h * d * 2
    return nbytes, 4.0 * keys * h * d


def _gathered(kc, vc, layer, pt, d):
    """[B, K, S, D] K/V gathered through the page tables (for SDPA)."""
    B, mp = pt.shape
    k = kc.shape[-1] // d
    idx = pt.long()
    kg = kc[layer][idx].reshape(B, mp * PS, k, d).transpose(1, 2).contiguous()
    vg = vc[layer][idx].reshape(B, mp * PS, k, d).transpose(1, 2).contiguous()
    return kg, vg


def decode_library(c):
    """One SDPA call on pre-gathered dense K/V computing the same function
    (no softcap/window: the timed cases have none)."""
    import torch
    import torch.nn.functional as F

    B, _, d = c["q"].shape
    kv = c["k_cache"].shape[-1] // d
    k, v = _gathered(c["k_cache"], c["v_cache"], c["layer"], c["page_tables"], d)
    S = k.shape[2]
    n = c["n_extra"]
    k = torch.cat([k, c["hk"][:, :n].reshape(B, n, kv, d).transpose(1, 2)], 2)
    v = torch.cat([v, c["hv"][:, :n].reshape(B, n, kv, d).transpose(1, 2)], 2)
    j = torch.arange(S + n, device=k.device)
    e = c["entry_positions"].long()[:, None]
    mask = torch.where(j < S, j < e, torch.ones_like(j, dtype=torch.bool))
    q = c["q"][:, :, None, :]  # [B, H, 1, D]
    m = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=c["scale"],
                                                  enable_gqa=True)


def prefill_library(c):
    import torch
    import torch.nn.functional as F

    d = c["q"].shape[-1]
    k, v = _gathered(c["k_cache"], c["v_cache"], c["layer"], c["page_tables"], d)
    S = k.shape[2]
    T = c["q"].shape[1]
    p = c["prefix_lens"].long()[:, None, None]
    tr = c["t_reals"].long()[:, None, None]
    j = torch.arange(S, device=k.device)[None, None, :]
    t = torch.arange(T, device=k.device)[None, :, None]
    m = ((j <= p + t) & (j < p + tr))[:, None]  # [Gs, 1, T, S]
    q = c["q"].transpose(1, 2)  # [Gs, H, T, D]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=c["scale"],
                                                  enable_gqa=True)


def check_close(name, got, want, rows=None):
    import torch

    if rows is not None:
        got, want = got[rows], want[rows]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    # a row is one query: the last two axes are (heads, head_dim)
    rms = w.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
    atol = (KERNEL_RMS_ATOL * rms).clamp(max=KERNEL_MAX_ATOL)
    limit = atol + KERNEL_RTOL * w.abs()
    ok = bool((err <= limit).all())
    mx = float(err.max())
    print(f"  {name}: max_abs_err={mx:.3e} (largest share of its limit "
          f"{float((err / limit.clamp(min=1e-30)).max()):.3f}, row rms {float(rms.min()):.3e}.."
          f"{float(rms.max()):.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version ({mx:.3e})")
    return mx


def time_case(label, kernel, plain, library, work) -> dict:
    """Kernel, plain and library times of one case two ways: device time
    with a cold L2 (``ms``, ``plain_ms``, ``library_ms``), and each call
    issued from an idle queue, host launch time included (``call_ms``,
    ``plain_call_ms``, ``library_call_ms``: the method of the port's first
    measurements, so that older figures compare like for like); and the
    case's bound."""
    bms, by = bound_ms(*work)
    r = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
             call_ms=call_ms(kernel), plain_call_ms=call_ms(plain),
             library_call_ms=call_ms(library), bound_ms=bms, bound_by=by)
    print(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library {r['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}); from an idle "
          f"queue: kernel {r['call_ms']:.4f}, plain {r['plain_call_ms']:.4f}, "
          f"library {r['library_call_ms']:.4f}")
    return r


def phase_kernels(dev) -> dict:
    import torch

    from smg_tpu_torch.ops.attention import attention_decode_cached
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    gen = torch.Generator(device=dev).manual_seed(1234)
    rng_entries = lambda B, lo, hi, g=gen: torch.randint(  # noqa: E731
        lo, hi, (B,), generator=g, device=dev).tolist()
    # phase 20's rank shape draws from a generator of its own, so every other
    # case keeps the inputs of earlier measurements
    shapes = dict(SHAPES, tp_rank=rank_shape())
    gen_tp = torch.Generator(device=dev).manual_seed(2234)
    tp = f"tp{TP_SIZE}"

    # decode: (label, B, entries, n_extra, softcap, window, pad_row, shape, timed).
    # The random entries are drawn first, in list order, and new cases go
    # after B32_ragged, so its entries (and bound) stay those of earlier
    # measurements.
    dcases = [
        ("B1_e4000", 1, [4000], 1, None, None, False, "llama3", False),
        ("B8_ragged_nx3_softcap", 8, rng_entries(8, 1, 4096), 3, 50.0, None, False,
         "llama3", False),
        ("B32_ragged_window1000", 32, rng_entries(32, 1, 4096), 1, None, 1000, False,
         "llama3", False),
        ("B8_window7_nx3", 8, rng_entries(8, 1, 4096), 3, None, 7, False, "llama3", False),
        ("B8_padded_row_softcap_window24", 8, rng_entries(8, 1, 4096), 1, 30.0, 24, True,
         "llama3", False),
        ("B32_ragged", 32, rng_entries(32, 1, 4096), 1, None, None, False, "llama3", True),
        # total keys (entry + n_extra) at split boundaries and one either side
        ("B9_split_edges", 9, [62, 63, 64, 126, 127, 128, 254, 255, 256], 1, None, None,
         False, "llama3", False),
        ("B3_split_edges_1024", 3, [1022, 1023, 1024], 1, None, None, False, "llama3",
         False),
        ("B1_window100_two_splits", 1, [3000], 1, None, 100, False, "llama3", False),
        ("B4_padded_row_nx4", 4, rng_entries(4, 900, 1100), 4, None, None, True, "llama3",
         False),
        ("B2_d256_g2_softcap", 2, [700, 3000], 2, 50.0, None, False, "d256_g2", False),
        ("B2_d64_g1_window", 2, [700, 3000], 2, None, 500, False, "d64_g1", False),
        ("B2_d96_g1", 2, [700, 3000], 2, None, None, False, "d96_g1", False),
        ("B2_d80_g4_softcap", 2, [700, 3000], 2, 50.0, None, False, "d80_g4", False),
        ("B4_e1000_nx4", 4, rng_entries(4, 950, 1050), 4, None, None, False, "llama3", True),
        ("B1_e8000", 1, [8000], 1, None, None, False, "llama3", True),
        # Qwen3-30B-A3B's attention shape (G=8); drawn after every case above
        ("B32_ragged_g8", 32, rng_entries(32, 1, 4096), 1, None, None, False, "qwen3_moe",
         True),
        ("B4_e1000_nx4_g8", 4, rng_entries(4, 950, 1050), 4, None, None, False, "qwen3_moe",
         True),
        ("B9_split_edges_g8", 9, [62, 63, 64, 126, 127, 128, 254, 255, 256], 1, None, None,
         False, "qwen3_moe", False),
        ("B4_padded_row_nx4_g8", 4, rng_entries(4, 900, 1100), 4, None, None, True,
         "qwen3_moe", False),
        # Qwen2-VL-7B's (G=7); drawn after every case above
        ("B32_ragged_g7", 32, rng_entries(32, 1, 4096), 1, None, None, False, "qwen2_vl",
         True),
        ("B4_e1000_nx4_g7", 4, rng_entries(4, 950, 1050), 4, None, None, False, "qwen2_vl",
         True),
        ("B1_e8000_g7", 1, [8000], 1, None, None, False, "qwen2_vl", True),
        ("B9_split_edges_g7", 9, [62, 63, 64, 126, 127, 128, 254, 255, 256], 1, None, None,
         False, "qwen2_vl", False),
        ("B4_padded_row_nx4_softcap_window_g7", 4, rng_entries(4, 900, 1100), 4, 50.0, 64,
         True, "qwen2_vl", False),
        # one rank of phase 20's tp engine (G=4 over K*D = 512 lanes)
        (f"B32_ragged_{tp}", 32, rng_entries(32, 1, 4096, gen_tp), 1, None, None, False,
         "tp_rank", True),
        (f"B4_e1000_nx4_{tp}", 4, rng_entries(4, 950, 1050, gen_tp), 4, None, None, False,
         "tp_rank", True),
        (f"B9_split_edges_{tp}", 9, [62, 63, 64, 126, 127, 128, 254, 255, 256], 1, None, None,
         False, "tp_rank", False),
        (f"B4_padded_row_nx4_softcap_window_{tp}", 4, rng_entries(4, 900, 1100, gen_tp), 4,
         50.0, 64, True, "tp_rank", False),
    ]
    d_err, d_timed = 0.0, {}
    for label, B, entries, nx, cap, win, pad, shape, timed in dcases:
        c = decode_case(B, entries, 4, nx, cap, win, gen_tp if shape == "tp_rank" else gen,
                        dev, pad_row=pad, shape=shapes[shape])
        got = dk.paged_attention_decode_cached(**c)
        want = attention_decode_cached(**c)
        torch.cuda.synchronize()
        d_err = max(d_err, check_close(f"decode {label}", got, want))
        if timed:
            d_timed[label] = time_case(
                f"decode {label}", lambda: dk.paged_attention_decode_cached(**c),  # noqa: B023
                lambda: attention_decode_cached(**c), decode_library(c), decode_work(c))  # noqa: B023

    # prefill: (label, T, prefixes, t_reals, softcap, window, shape, timed)
    pcases = [
        ("T128_cold", 128, [0], [128], None, None, "llama3", False),
        ("T128_prefix1000_softcap", 128, [1000], [128], 50.0, None, "llama3", False),
        ("T512_cold_window7", 512, [0], [500], None, 7, "llama3", False),
        ("T512_prefix1000_window300", 512, [1000], [512], 30.0, 300, "llama3", False),
        ("G3_T128_mixed", 128, [0, 1000, 37], [128, 100, 5], None, None, "llama3", False),
        ("T500_prefix1037", 500, [1037], [500], None, None, "llama3", False),
        ("D64_G1_T256_prefix300", 256, [300], [250], None, None, "d64_g1", False),
        ("D256_G2_T256_prefix300_softcap_window", 256, [300], [256], 50.0, 200, "d256_g2",
         False),
        ("D96_G1_T256_prefix300", 256, [300], [250], None, None, "d96_g1", False),
        ("D80_G4_T256_prefix300_softcap", 256, [300], [256], 50.0, None, "d80_g4", False),
        ("T512_prefix1000", 512, [1000], [512], None, None, "llama3", True),
        ("Gs8_T512_cold", 512, [0] * 8, [512, 480, 400, 300, 200, 128, 90, 17], None, None,
         "llama3", True),
        ("G3_T128_mixed_g8", 128, [0, 1000, 37], [128, 100, 5], None, None, "qwen3_moe",
         False),
        ("T512_prefix1000_g8", 512, [1000], [512], None, None, "qwen3_moe", True),
        ("Gs8_T512_cold_g8", 512, [0] * 8, [512, 480, 400, 300, 200, 128, 90, 17], None,
         None, "qwen3_moe", True),
        ("G3_T128_mixed_g7", 128, [0, 1000, 37], [128, 100, 5], None, None, "qwen2_vl",
         False),
        ("T130_prefix37_softcap_window_g7", 130, [37], [121], 50.0, 40, "qwen2_vl", False),
        ("T512_prefix1000_g7", 512, [1000], [512], None, None, "qwen2_vl", True),
        ("Gs8_T512_cold_g7", 512, [0] * 8, [512, 480, 400, 300, 200, 128, 90, 17], None,
         None, "qwen2_vl", True),
        (f"G3_T128_mixed_{tp}", 128, [0, 1000, 37], [128, 100, 5], None, None, "tp_rank",
         False),
        (f"T512_prefix1000_{tp}", 512, [1000], [512], None, None, "tp_rank", True),
        (f"Gs8_T512_cold_{tp}", 512, [0] * 8, [512, 480, 400, 300, 200, 128, 90, 17], None,
         None, "tp_rank", True),
    ]
    p_err, p_timed = 0.0, {}
    for label, T, pfx, trs, cap, win, shape, timed in pcases:
        c = prefill_case(T, pfx, trs, cap, win, gen_tp if shape == "tp_rank" else gen, dev,
                         shape=shapes[shape])
        plain = lambda: pk.plain_prefill_batched(  # noqa: E731
            c["q"], c["k_cache"], c["v_cache"], c["layer"], c["page_tables"],  # noqa: B023
            c["prefix_lens"], c["t_reals"], c["scale"], c["softcap"], c["window"])  # noqa: B023
        got = pk.paged_attention_prefill_batched(**c)
        want = plain()
        torch.cuda.synchronize()
        for g, tr in enumerate(trs):  # rows past t_real are padding
            p_err = max(p_err, check_close(f"prefill {label} row{g}", got[g, :tr], want[g, :tr]))
        if timed:
            p_timed[label] = time_case(
                f"prefill {label}", lambda: pk.paged_attention_prefill_batched(**c),  # noqa: B023
                plain, prefill_library(c), prefill_work(c))

    results = {}
    for name, err, timed, main in (
        ("decode_attention", d_err, d_timed, "B32_ragged"),
        ("prefill_attention", p_err, p_timed, "T512_prefix1000"),
    ):
        results[name] = dict(timed[main], max_abs_err=err, timed_case=main,
                             timed_cases=timed)
    return results


# ---- phase 3: the engine on Llama-3-8B ----

def _requests(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    tok = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    shared = tok(600)
    first = [
        ("long_chunked", tok(1400)),  # > max_prefill_tokens: 3 chunks
        ("shared_a", shared + tok(40)),
        ("short", tok(200)),
        ("short2", tok(90)),
    ]
    later = [("shared_b", shared + tok(60))]  # after shared_a finished: radix hit
    return first, later


# (label, attention, decode_graphs, overlap_schedule, background loop): the
# serving path (CUDA graphs, the overlap pipeline, the loop thread), the
# eager synchronous path on the same kernels, and the plain attention
PATHS = (
    ("graphs", "kernel", True, True, True),
    ("eager", "kernel", False, False, False),
    ("plain", "plain", False, False, False),
)
LOOP_WAIT_S = 300  # deadline of every wait on the engine's loop thread


def wait_for(cond, what: str, timeout: float = LOOP_WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not done within {timeout} s")
        time.sleep(0.001)


def drive_engine(engine, max_new: int, record_logits: list, loop: bool, requests=None):
    """Submit the requests from this thread with ``on_output`` callbacks:
    phase 3's (``_requests``), or ``requests(engine)`` = (first, later,
    anchor), each request (rid, ids[, mm_embeds]), ``later`` submitted once
    ``anchor`` finished.
    With ``loop`` the engine's own thread steps (``engine.start()``);
    otherwise this thread calls ``step()``.  Returns per-request results,
    the wall time of every step, the phase split (synchronous paths only:
    timing a pipelined call would need a sync that defeats the pipeline)
    with each request's ms from its submit to its first output
    (``ttft_ms``) and the graph-capture ms inside that span
    (``ttft_capture_ms``: a fresh engine captures a decode shape at its first
    launch, in the step that delivers first tokens), and the drive's wall
    time."""
    import torch

    from smg_tpu_torch.engine.engine import collect_result
    from smg_tpu_torch.protocols.sampling import SamplingParams

    runner = engine.runner
    model = runner.model
    orig = model.forward_prefill_batched

    def recording(*a, **kw):
        out = orig(*a, **kw)
        if out is not None:
            record_logits.append(out.float().cpu())
        return out

    model.forward_prefill_batched = recording
    timers = {"prefill_s": 0.0, "decode_s": 0.0, "ttft_ms": {}, "ttft_capture_ms": {}}
    if not loop:
        def timed(name, fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timers[name] += time.perf_counter() - t0
                return out
            return wrapper

        runner.prefill_extend = timed("prefill_s", runner.prefill_extend)
        runner.prefill_batched = timed("prefill_s", runner.prefill_batched)
        runner.decode_multi_async = timed("decode_s", runner.decode_multi_async)
        runner.decode_fetch = timed("decode_s", runner.decode_fetch)
    step_ms = []
    step = engine.step

    def timed_step():  # the loop thread calls engine.step
        t0 = time.perf_counter()
        out = step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.step = timed_step
    first, later, anchor = requests(engine) if requests else (*_requests(7), "shared_a")
    chunks: dict[str, list] = {}
    sp = lambda: SamplingParams(temperature=0.0, max_new_tokens=max_new, ignore_eos=True)  # noqa: E731

    def submit(batch):
        for rid, ids, *mm in batch:
            chunks[rid] = []
            t_submit, cap0 = time.perf_counter(), runner.graphs.capture_s

            def on_output(out, rid=rid, t_submit=t_submit, cap0=cap0):
                if not chunks[rid]:
                    timers["ttft_ms"][rid] = (time.perf_counter() - t_submit) * 1e3
                    timers["ttft_capture_ms"][rid] = (runner.graphs.capture_s - cap0) * 1e3
                chunks[rid].append(out)

            engine.submit(ids, sp(), rid=rid, on_output=on_output,
                          mm_embeds=mm[0] if mm else None)

    finished = lambda rid: bool(chunks[rid]) and chunks[rid][-1].finished  # noqa: E731
    t0 = time.perf_counter()
    if loop:
        engine.start()
        with engine._lock:  # a batch lands between two steps, as on the sync path
            submit(first)
        wait_for(lambda: finished(anchor), anchor)
        with engine._lock:
            submit(later)  # after the anchor finished: a radix hit
        wait_for(lambda: all(finished(r) for r in chunks) and not engine.has_work(),
                 "every request")
        engine.stop()
    else:
        submit(first)
        while engine.has_work() or later:
            if later and finished(anchor):
                submit(later)
                later = []
            engine.step()
            if len(step_ms) > 500:
                raise RuntimeError("engine did not finish within 500 steps")
    wall_s = time.perf_counter() - t0
    del engine.step
    results = {rid: collect_result(rid, c) for rid, c in chunks.items()}
    model.forward_prefill_batched = orig
    return results, step_ms, timers, wall_s


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work in a trace


ATTENTION_KERNELS = ("decode_fma_kernel", "decode_tc_kernel", "prefill_fma_kernel",
                     "prefill_tc_kernel", "prefill_wg_kernel")


def device_time(prof, classes: dict | None = None) -> tuple[float, dict, int]:
    """(busy ms, ms by kernel name, number of device events) from the
    profiler's trace: device events only, busy time as the union of their
    intervals.  ``key_averages()`` would also count the operator
    annotations the trace places on the device timeline, which repeat the
    time of the kernels under them.  A ``classes`` dict is filled with the
    device ms of each op class: the attention kernels by name, kernels that
    start inside a ``moe_*`` annotation (``moe_annotations``) by its name,
    and the rest."""
    import bisect
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans, by_name = [], {}
    notes = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"])
                   for ev in events if ev.get("cat") == "gpu_user_annotation"
                   and str(ev.get("name", "")).startswith("moe_") and ev.get("ph") == "X")
    starts = [n[0] for n in notes]
    for ev in events:
        if ev.get("cat") in DEVICE_CATS and ev.get("ph") == "X":
            t0, dur = float(ev["ts"]), float(ev["dur"])
            spans.append((t0, t0 + dur))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + dur / 1e3
            if classes is None:
                continue
            cls = "rest"
            if any(k in ev["name"] for k in ATTENTION_KERNELS):
                cls = "attention_kernels"
            else:
                i = bisect.bisect_right(starts, t0) - 1
                if i >= 0 and notes[i][0] <= t0 < notes[i][1]:
                    cls = notes[i][2]
            classes[cls] = classes.get(cls, 0.0) + dur / 1e3
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, by_name, len(spans)


def profile_decode(engine, loop: bool, columns: int = 8, sampling=None,
                   label: str = "decode profile", submit=None) -> dict:
    """Decode of 4 lanes with 1000-token prompts, horizon 4 (greedy unless
    ``sampling`` gives the 4 lanes' parameters; ``submit(rid, prompt, sp,
    on_output)`` puts a lane on the engine in place of ``engine.submit``,
    as phase 13 adopts them from a prefill engine), under torch.profiler:
    device time by kernel, device events and the busy share (device busy
    time over the wall time of the same columns).  With ``loop`` the
    engine's thread steps and the window closes once ``columns`` more
    columns were launched; otherwise this thread steps.  For a graph path
    the window's megastep shape is also timed alone with CUDA events
    (``replay_ms``, a cold L2), whatever the profiler sees inside graph
    replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smg_tpu_torch.protocols.sampling import SamplingParams

    sched, runner = engine.scheduler, engine.runner
    sampling = sampling or [SamplingParams(temperature=0.0, max_new_tokens=128,
                                           ignore_eos=True)] * 4
    outs: dict[str, list] = {}
    for i, sp in enumerate(sampling):
        outs[f"prof{i}"] = []
        (submit or (lambda rid, prompt, sp, cb: engine.submit(prompt, sp, rid=rid,
                                                              on_output=cb)))(
            f"prof{i}", list(range(2000 + 1000 * i, 3000 + 1000 * i)), sp,
            outs[f"prof{i}"].append)
    if loop:
        engine.start()
        # every lane decoding and the queue empty: horizons are 4 wide
        wait_for(lambda: all(len(o) >= 2 for o in outs.values()), "profile prefill")
    else:
        while sched.waiting or any(r is not None and r.status.value == "prefilling"
                                   for r in sched.slots):
            engine.step()
    for _attempt in range(3):
        # hold the loop thread between two steps while the profiler starts
        # (it takes longer than the lanes' remaining tokens); the window
        # opens when the engine lock is let go.  The profiler starts and
        # stops only under the lock, so never while the loop thread
        # captures a graph, and the card is never synchronised then either.
        engine._lock.acquire()
        torch.cuda.synchronize()  # nothing of before the window in the trace
        capture0 = runner.graphs.capture_s
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        t0 = time.perf_counter()
        cols0, calls0 = runner.stats["decode_columns"], runner.stats["decode_calls"]
        engine._lock.release()
        if loop:
            wait_for(lambda: runner.stats["decode_columns"] - cols0 >= columns, "profile")
        else:
            while runner.stats["decode_columns"] - cols0 < columns:
                engine.step()
        with engine._lock:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.stop()
        if runner.graphs.capture_s == capture0:
            break
        # the window's first launch of a new shape was captured in it: the
        # capture is start-up work, not decode, so measure the next columns
        print(f"  {label}: a graph was captured in the window; measuring again")
    cols = runner.stats["decode_columns"] - cols0
    launches = runner.stats["decode_calls"] - calls0
    classes: dict = {}
    busy, by_kernel, n_events = device_time(prof, classes)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the window is read: the lanes' remaining tokens are aborted, not
    # decoded (on a slow path that was 10-15 s of a profile)
    for rid in outs:
        engine.abort(rid)
    if loop:
        wait_for(lambda: not engine.has_work(), "profile drain")
        engine.stop()
    else:
        while engine.has_work():
            engine.step()
    out = dict(columns=cols, launches=launches, lanes=4, wall_ms_per_column=wall_ms / cols,
               device_ms_per_column=busy / cols, busy_share=busy / wall_ms,
               device_events_per_column=n_events / cols,
               decode_tok_s=4 * cols / wall_ms * 1e3,
               top=[(name[:80], ms / cols) for name, ms in top],
               by_class_ms_per_column={k: ms / cols for k, ms in classes.items()})
    K = round(cols / launches)  # the window's horizon
    pen = any(sp.has_penalties for sp in sampling)
    lora = any(sp.lora_adapter for sp in sampling)
    graphs = [s for s in runner.graphs.steps.values()
              if s.graph is not None and s.K == K and s.use_pen == pen and not s.use_mask
              and s.use_lora == lora]
    if graphs:
        st = max(graphs, key=lambda s: s.mp)  # the shape the window replayed
        out["replay_ms"] = cuda_ms(st.graph.replay)
        out["replay_ms_per_column"] = out["replay_ms"] / st.K
        out["replay_shape"] = dict(B=st.B, mp=st.mp, K=st.K, E=st.E, use_pen=st.use_pen,
                                   use_lora=st.use_lora)
        out["replay_busy_share"] = out["replay_ms_per_column"] / out["wall_ms_per_column"]
    print(f"  {label}: {cols} columns in {launches} launches, "
          f"wall {out['wall_ms_per_column']:.2f} ms/column, "
          f"device busy {out['device_ms_per_column']:.2f} ms/column "
          f"(busy share {out['busy_share']:.3f}), "
          f"{out['device_events_per_column']:.0f} device events/column, "
          f"{out['decode_tok_s']:.2f} decode tokens/s"
          + (f"; one replay alone {out['replay_ms']:.3f} ms = {out['replay_ms_per_column']:.3f}"
             f" ms/column (busy share by it {out['replay_busy_share']:.3f})"
             if graphs else ""))
    for name, ms in out["top"]:
        print(f"    {ms:8.3f} ms/column  {name}")
    return out


def serve_paths(cfg, params, dev, max_new: int, with_profile: bool = False,
                auto_size: bool = False, after=None, paths=PATHS, sched=None,
                requests=None, engine_kw=None) -> dict:
    """Serve the requests once per path of ``paths`` on one set of weights.
    Launch counters are zeroed just before each measured run and read just
    after it.  With ``auto_size`` each engine sizes its KV cache from the
    card's free memory (the serving default) instead of 2048 pages.
    ``sched`` overrides ``SchedulerConfig`` fields of every engine.
    ``after(label, engine)``, called once the run and its profile are read,
    returns further readings of that engine (``runs[label]["after"]``).
    ``requests`` replaces phase 3's requests (``drive_engine``);
    ``engine_kw`` are further ``Engine`` arguments."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    runs = {}
    for label, attention, graphs, overlap, loop in paths:
        econf = EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=auto_size,
                              dtype=cfg.dtype),
            scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      overlap_schedule=overlap, **(sched or {})),
            decode_graphs=graphs,
        )
        engine = Engine(econf, params=params, device=dev, attention=attention,
                        **(engine_kw or {}))
        if auto_size:
            sp, rs = engine.runner.spec, engine.runner.reserve_bytes
            print(f"  [{label}] auto-sized KV: {sp.num_pages} pages of {sp.bytes_per_page} "
                  f"bytes ({sp.num_pages * sp.bytes_per_page} bytes) after a reserve of "
                  f"{rs} bytes for the expert layer and the vision tower")
        # warm-up request (cuBLAS handles, allocator, a first graph); not counted
        engine.generate(prompt_ids=list(range(1000, 1100)),
                        sampling=SamplingParams(temperature=0.0, max_new_tokens=4))
        for k in engine.runner.stats:
            engine.runner.stats[k] = 0
        engine.scheduler.num_decode_tokens = 0
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved(dev)
        logits: list = []
        dk.launches = 0
        pk.launches = 0
        results, step_ms, timers, wall_s = drive_engine(engine, max_new, logits, loop,
                                                        requests)
        torch.cuda.synchronize()
        launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        loads = engine.loads()
        runs[label] = dict(results=results, step_ms=step_ms, timers=timers, wall_s=wall_s,
                           logits=logits, stats=dict(engine.runner.stats),
                           pages=engine.runner.spec.num_pages,
                           launches=launches, loads=loads,
                           reserved_growth=torch.cuda.memory_reserved(dev) - reserved0,
                           decode_tokens=engine.scheduler.num_decode_tokens)
        if loads["audit"]["leaked_pages"] or not loads["audit"]["clean"]:
            raise AssertionError(f"[{label}] audit not clean: {loads['audit']}")
        if with_profile:  # after the measured run: its counts are already read
            runs[label]["profile"] = profile_decode(engine, loop)
        if after is not None:
            runs[label]["after"] = after(label, engine)
        del engine
        gc.collect()  # drive_engine's timers hold the runner in a cycle
        torch.cuda.empty_cache()  # give the KV buffers back before the next engine
    return runs


GUARD_MEGASTEPS = 16  # decode megasteps of each of phase 3's two windows
GUARD_WARM_TOKENS = 40  # tokens each lane decodes before the windows


def guarded_decode(engine, dev, card: str, megasteps: int = GUARD_MEGASTEPS) -> dict:
    """Phase 3's guarded window, on the serving path (graphs, the overlap
    pipeline, the loop thread) after its run and profile: 4 greedy lanes of
    1000-token prompts decode ``GUARD_WARM_TOKENS`` tokens (past their
    64-page table's end, so the 128-page shape is captured before any
    window), the auditor is armed, ``megasteps`` megasteps run unguarded,
    then as many inside ``steady_state_guard``: no capture or kernel build,
    no flagged sync (the sync debug mode is process-wide: a sync the loop
    thread hits raises inside its step, which the scheduler counts as a
    step failure), ``program_audit`` clean.  Inside the guard, ``.item()``
    on a device tensor on this thread must raise.  No request is admitted
    while either window is open.  Returns both windows' wall ms per decode
    column (from one megastep launch to the launch ``megasteps`` later)."""
    import torch

    from smg_tpu_torch.analysis import steady_state_guard
    from smg_tpu_torch.protocols.sampling import SamplingParams

    sched, runner = engine.scheduler, engine.runner
    K = engine.config.scheduler.decode_horizon
    n_new = GUARD_WARM_TOKENS + 2 * (megasteps + 2) * K
    sp = SamplingParams(temperature=0.0, max_new_tokens=n_new, ignore_eos=True)
    outs = {f"guard{i}": [] for i in range(4)}
    for i, (rid, sink) in enumerate(outs.items()):
        engine.submit(list(range(2000 + 1000 * i, 3000 + 1000 * i)), sp, rid=rid,
                      on_output=sink.append)
    engine.start()
    tokens = lambda rid: sum(len(o.new_token_ids) for o in outs[rid])  # noqa: E731
    wait_for(lambda: all(tokens(r) >= GUARD_WARM_TOKENS for r in outs), "guard warm-up")
    runner._programs.arm()

    def window() -> tuple:
        start = runner.stats["decode_calls"]
        wait_for(lambda: runner.stats["decode_calls"] > start, "a megastep launch")
        calls0, cols0 = runner.stats["decode_calls"], runner.stats["decode_columns"]
        t0 = time.perf_counter()
        wait_for(lambda: runner.stats["decode_calls"] - calls0 >= megasteps, "decode window")
        ms = (time.perf_counter() - t0) * 1e3
        cols = runner.stats["decode_columns"] - cols0
        return ms / cols, cols

    unguarded_ms, _cols = window()
    failures0 = sched.num_step_failures + sched.num_quarantined
    item_error = None
    with steady_state_guard(device=dev) as cc:
        guarded_ms, cols = window()
        try:
            torch.ones(1, device=dev).item()
        except RuntimeError as e:  # the guard is live: a host sync raises
            item_error = str(e).splitlines()[0]
    flagged = sched.num_step_failures + sched.num_quarantined - failures0
    audit = engine.program_audit()
    wait_for(lambda: all(o and o[-1].finished for o in outs.values())
             and not engine.has_work(), "guard drain")
    engine.stop()
    finished = {rid: (tokens(rid), o[-1].finish_reason) for rid, o in outs.items()}
    out = dict(megasteps=megasteps, columns=cols, unguarded_ms_per_column=unguarded_ms,
               guarded_ms_per_column=guarded_ms, captures=cc.count, flagged_syncs=flagged,
               sync_debug_mode=cc.report["sync_debug_mode"], item_raised=item_error,
               audit_clean=audit["clean"], audit_recompiles=audit["recompiles"],
               audited_programs=sum(1 for p in audit["programs"] if p["audited"]),
               off_device_inputs=audit["off_device_inputs"],
               storage_moves=audit["storage_moves"],
               unexplained_captures=audit["unexplained_captures"])
    print(f"  [graphs] guarded window: {megasteps} megasteps, {cols} columns, "
          f"{guarded_ms:.3f} ms/column guarded against {unguarded_ms:.3f} unguarded just "
          f"before; {cc.count} captures, {flagged} flagged syncs, sync debug mode "
          f"{cc.report['sync_debug_mode']!r}; .item() under the guard raised: "
          f"{item_error!r}; program_audit clean {audit['clean']} over "
          f"{out['audited_programs']} audited shapes ({card})")
    bad = []
    if cc.report["sync_debug_mode"] != "error" or item_error is None:
        bad.append(f"the sync guard is not live: {cc.report}, .item() raised {item_error!r}")
    if flagged:
        bad.append(f"{flagged} step failures or quarantines in the guarded window (a "
                   "flagged host sync on the loop thread)")
    if not audit["clean"]:
        bad.append(f"program_audit not clean: {audit}")
    if any(v != (n_new, "length") for v in finished.values()):
        bad.append(f"guarded lanes did not finish whole: {finished}")
    if bad:
        raise AssertionError(f"phase 3 guarded window: {bad}")
    return out


def check_launches(r, L: int, label: str, plain: bool) -> None:
    """A run's kernel launches equal its schedule: L per decode column
    (graph replays included) and L per prefill call, and the plain path
    launches none."""
    st = r["stats"]
    expect = ({"decode_attention": 0, "prefill_attention": 0} if plain else
              {"decode_attention": L * st["decode_columns"],
               "prefill_attention": L * st["prefill_calls"]})
    print(f"  [{label}] schedule: {st}; launches {r['launches']}, expected {expect}")
    if r["launches"] != expect or (not plain and min(r["launches"].values()) <= 0):
        raise AssertionError(f"[{label}] launch counts {r['launches']} != {expect}")


def check_runs(runs, L: int, max_new: int, label: str, hit: str = "shared_b") -> dict:
    """Counts, finishes, the radix hit (request ``hit``) and the audit of
    every run; returns first-token logit gaps and greedy-stream agreement of
    each path with the plain run and of the graph path with the eager one
    (of the paths that ran)."""
    import torch

    for name, r in runs.items():
        for rid, res in r["results"].items():
            if res.output_tokens != max_new or res.finish_reason != "length":
                raise AssertionError(f"[{label}/{name}] {rid}: expected {max_new} tokens, "
                                     f"finish 'length'")
        if r["results"][hit].cached_tokens <= 0:
            raise AssertionError(f"[{label}/{name}] {hit} got no radix prefix hit")
        check_launches(r, L, f"{label}/{name}", plain=name == "plain")
    for rid, res in runs["graphs"]["results"].items():
        print(f"  [{label}] {rid}: prompt {res.prompt_tokens}, cached {res.cached_tokens}, "
              f"output {res.output_tokens}, finish {res.finish_reason}")
    n_logits = {len(r["logits"]) for r in runs.values()}
    if len(n_logits) != 1:
        raise AssertionError(f"[{label}] the runs ran different prefill schedules")
    if not all(bool(torch.isfinite(a).all()) for r in runs.values() for a in r["logits"]):
        raise AssertionError(f"[{label}] non-finite first-token logits")

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(runs[a]["logits"],
                                                                runs[b]["logits"]))

    def agree(a, b):
        return sum(runs[a]["results"][rid].token_ids == runs[b]["results"][rid].token_ids
                   for rid in runs[a]["results"])

    pairs = [(a, b) for a, b in (("graphs", "eager"), ("eager", "plain"), ("graphs", "plain"))
             if a in runs and b in runs]
    some = next(iter(runs.values()))
    out = dict(logit_gap={f"{a}_vs_{b}": gap(a, b) for a, b in pairs},
               streams_equal={f"{a}_vs_{b}": agree(a, b) for a, b in pairs},
               max_abs_logit=max(float(b.abs().max()) for b in some["logits"]))
    print(f"  [{label}] first-token logits: max_abs_diff {out['logit_gap']} "
          f"(max |logit| {out['max_abs_logit']:.3f}); greedy streams equal (of "
          f"{len(some['results'])}): {out['streams_equal']}")
    return out


def _widen(params: dict) -> None:
    """Cast every weight to float32 in place, one tensor at a time."""
    for group in (params, params["layers"]):
        for k, v in group.items():
            if k != "layers":
                group[k] = v.float()


def summarize(runs, card: str, label: str) -> dict:
    out = {}
    for name, r in runs.items():
        s, loads = r["stats"], r["loads"]
        row = dict(
            wall_s=r["wall_s"],
            tok_s=sum(res.output_tokens for res in r["results"].values()) / r["wall_s"],
            steps=len(r["step_ms"]),
            step_ms_median=statistics.median(r["step_ms"]),
            step_ms_max=max(r["step_ms"]),
            decode_columns=s["decode_columns"],
            lookahead_kept=loads["lookahead_kept"],
            lookahead_discarded=loads["lookahead_discarded"],
            decode_graphs=loads["decode_graphs"],
            graph_capture_s=loads["graph_capture_s"],
            graph_capture_bytes=loads["graph_capture_bytes"],
            reserved_growth_bytes=r["reserved_growth"],
        )
        if r["timers"]["decode_s"]:  # synchronous paths: the phase split
            row.update(prefill_tok_s=s["prefill_tokens"] / r["timers"]["prefill_s"],
                       decode_tok_s_drive=r["decode_tokens"] / r["timers"]["decode_s"],
                       decode_ms_per_column=r["timers"]["decode_s"] * 1e3 / s["decode_columns"])
        if "profile" in r:
            p = r["profile"]
            row.update({k: p[k] for k in ("decode_tok_s", "wall_ms_per_column",
                                          "device_ms_per_column", "busy_share",
                                          "device_events_per_column") if k in p})
            row.update({k: p[k] for k in ("replay_ms_per_column", "replay_busy_share")
                        if k in p})
        out[name] = row
        print(f"  [{card}] {label} {name}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return out


def phase_preempt(dev) -> dict:
    """Preemption on the card: Llama-3-8B at full width, 4 layers, float32
    weights and KV, the serving path (graphs, overlap, loop).  A pool of
    21 pages cannot grow four 64-token prompts to 112 tokens each; the
    greedy streams must equal a run with room to spare, with no page
    leaked."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine, collect_result
    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.protocols.sampling import SamplingParams

    cfg = dataclasses.replace(llama3_8b_config(), num_layers=4, dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), dev)
    rng = np.random.default_rng(11)
    jobs = [(f"p{i}", rng.integers(1000, 120000, 64).tolist()) for i in range(4)]

    def run(num_pages: int):
        engine = Engine(EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=PS, num_pages=num_pages, auto_size=False,
                              dtype="float32"),
            scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=512,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      watermark_pages=1)), params=params, device=dev)
        chunks = {rid: [] for rid, _ in jobs}
        engine.start()
        try:
            for rid, ids in jobs:
                engine.submit(ids, SamplingParams(temperature=0.0, max_new_tokens=48,
                                                  ignore_eos=True),
                              rid=rid, on_output=chunks[rid].append)
            wait_for(lambda: all(c and c[-1].finished for c in chunks.values())
                     and not engine.has_work(), "preemption run")
        finally:
            engine.stop()
        loads = engine.loads()
        streams = {rid: collect_result(rid, c).token_ids for rid, c in chunks.items()}
        del engine
        gc.collect()
        return streams, loads

    want, roomy = run(256)
    got, tight = run(22)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    audit = tight["audit"]
    out = dict(preemptions=tight["preemptions"], unpressured_preemptions=roomy["preemptions"],
               streams_equal=sum(got[r] == want[r] for r in want), requests=len(want),
               leaked_pages=audit["leaked_pages"], clean=audit["clean"],
               decode_graphs=tight["decode_graphs"])
    print(f"  preemption (4 layers, f32, 21 pages): {out}")
    if out["preemptions"] <= 0 or out["streams_equal"] != len(want) or out["leaked_pages"] \
            or not out["clean"]:
        raise AssertionError(f"preemption check failed: {out}")
    return out


# ---- phase 4: request semantics on Llama-3-8B ----

PIECE_ALPHABET = '{}[]":,. 0123456789abcdefghijklmnopqrstuvwxyz'
REGEX_E = r"[a-z]{2,6}(,[0-9]{1,3}){2}"
NEVER_STOP = "~"  # outside the alphabet: a stop-string lane that never stops


class PieceTokenizer:
    """A synthetic tokenizer at Llama-3's vocabulary, a test harness and not
    part of the port (no tokenizer file is in the repository).  The
    config's BOS and EOS ids are special and decode to nothing; every other
    id is a fixed piece of 1-3 characters over a JSON-capable alphabet,
    drawn from a seed (the first ids after 1 hold each character alone);
    ``decode`` concatenates the pieces.  With it the JSON, regex and
    stop-string paths do their full work over all 128256 ids."""

    def __init__(self, vocab_size: int, special_ids, seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(seed)
        lens = rng.integers(1, 4, vocab_size).tolist()
        chars = rng.integers(0, len(PIECE_ALPHABET), (vocab_size, 3)).tolist()
        self.pieces = ["".join(PIECE_ALPHABET[c] for c in row[:n])
                       for row, n in zip(chars, lens)]
        self.pieces[2:2 + len(PIECE_ALPHABET)] = list(PIECE_ALPHABET)
        for t in special_ids:
            self.pieces[t] = ""

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(self.pieces[t] for t in ids)


def _request_jobs(seed: int, stop_d: str | None):
    """D's prompt and the six requests (D first: its 1100-token prompt
    prefills alone in three chunks, as in the probe).  ``stop_d`` None
    gives D's prompt only."""
    import numpy as np

    from smg_tpu_torch.protocols.sampling import SamplingParams as SP

    rng = np.random.default_rng(seed)
    tok = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    prompt_d = tok(1100)
    if stop_d is None:
        return prompt_d
    greedy = dict(temperature=0.0, max_new_tokens=32, ignore_eos=True)
    return [
        ("D", prompt_d, SP(**greedy, stop=[stop_d])),
        ("A", tok(80), SP(**greedy, frequency_penalty=0.5, presence_penalty=0.3)),
        ("B", tok(80), SP(**greedy, repetition_penalty=1.3)),
        ("C", tok(80), SP(temperature=0.8, max_new_tokens=32, ignore_eos=True,
                          frequency_penalty=0.4)),
        ("E", tok(40), SP(temperature=0.0, max_new_tokens=16, regex=REGEX_E)),
        ("F", tok(40), SP(temperature=0.7, max_new_tokens=16, json_schema="{}")),
    ]


def drive_requests(engine, jobs, loop: bool, mask_ms: dict):
    """Submit ``jobs`` with ``on_output`` callbacks, then step them to the
    end on the engine's loop thread (``loop``) or from this thread.  Every
    grammar mask the scheduler derives is timed on the host into
    ``mask_ms`` by kind.  Returns (results, wall s)."""
    from smg_tpu_torch.engine.engine import collect_result

    sched = engine.scheduler
    mask_for = sched._mask_for

    def timed_mask(req):
        t0 = time.perf_counter()
        m = mask_for(req)
        mask_ms["regex" if req.sampling.regex else "json"].append(
            (time.perf_counter() - t0) * 1e3)
        return m

    sched._mask_for = timed_mask
    chunks = {rid: [] for rid, _, _ in jobs}
    for rid, prompt, sp in jobs:  # all queued before the first step
        engine.submit(prompt, sp, rid=rid, on_output=chunks[rid].append)
    t0 = time.perf_counter()
    if loop:
        engine.start()
        wait_for(lambda: all(c and c[-1].finished for c in chunks.values())
                 and not engine.has_work(), "the six requests")
        engine.stop()
    else:
        for _ in range(1000):
            if not engine.has_work():
                break
            engine.step()
        else:
            raise RuntimeError("requests did not finish within 1000 steps")
    wall_s = time.perf_counter() - t0
    del sched._mask_for
    return {rid: collect_result(rid, c) for rid, c in chunks.items()}, wall_s


def penalty_ops_ms(dev, V: int, B: int = 8, K: int = 4) -> float:
    """Device ms per decode column of the penalty work a K-column megastep
    adds at batch bucket B: the rows' gather, ``apply_penalties`` and the
    count update per column, the write-back (``cuda_ms`` of one launch's
    share, divided by K)."""
    import torch

    from smg_tpu_torch.engine.sampling import apply_penalties

    gen = torch.Generator(device=dev).manual_seed(4)
    counts_buf = torch.randint(0, 3, (B + 1, V), generator=gen, device=dev, dtype=torch.int32)
    pmask_buf = torch.rand((B + 1, V), generator=gen, device=dev) < 0.01
    slot_idx = torch.arange(B, device=dev)
    logits = torch.randn((B, V), generator=gen, device=dev)
    toks = torch.randint(0, V, (B, K), generator=gen, device=dev)
    freqs, pres, reps = (torch.full((B,), x, device=dev) for x in (0.5, 0.3, 1.3))
    one = torch.ones((B, 1), dtype=torch.int32, device=dev)

    def launch():
        counts = counts_buf.index_select(0, slot_idx)
        pmask = pmask_buf.index_select(0, slot_idx)
        for j in range(K):
            apply_penalties(logits, counts, pmask, freqs, pres, reps)
            counts.scatter_add_(1, toks[:, j:j + 1], one)
        counts_buf.index_copy_(0, slot_idx, counts)

    return cuda_ms(launch) / K


def request_paths(cfg, params, dev, tok, label: str, filters: dict,
                  with_profile: bool = False) -> dict:
    """The six requests once per path of ``PATHS`` on one set of weights.
    Each engine first runs D's prompt alone, greedy, at horizon 1 (a stop
    string that never matches forces it) to take D's stop string from its
    tokens 10-12, then flushes its prefix cache; launch counters are zeroed
    just before the drive and read just after.  The three engines share
    ``filters`` (the grammar filters and their text-keyed mask caches), so
    the graph path, which runs first, pays for every mask it meets.  With
    ``with_profile`` the graph path also profiles decode on 4 lanes without
    and with penalties, and with a stop-string lane that forces horizon 1."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams as SP

    prompt_d = _request_jobs(5, None)
    runs = {}
    for name, attention, graphs, overlap, loop in PATHS:
        engine = Engine(EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
            scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      overlap_schedule=overlap),
            decode_graphs=graphs), params=params, device=dev, attention=attention,
            tokenizer=tok)
        engine._grammar_filters = filters.setdefault("grammar", {})
        engine._json_filter = filters.get("json")
        probe = engine.generate(prompt_d, SP(temperature=0.0, max_new_tokens=13,
                                             ignore_eos=True, stop=[NEVER_STOP]))
        stop_d = tok.decode(probe.token_ids[10:13])
        if not stop_d or not engine.flush_cache():
            raise AssertionError(f"[{label}/{name}] probe: stop text {stop_d!r}")
        for k in engine.runner.stats:
            engine.runner.stats[k] = 0
        torch.cuda.synchronize()
        mask_ms = {"regex": [], "json": []}
        dk.launches = 0
        pk.launches = 0
        results, wall_s = drive_requests(engine, _request_jobs(5, stop_d), loop, mask_ms)
        torch.cuda.synchronize()
        launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        filters["json"] = engine._json_filter
        runs[name] = dict(results=results, wall_s=wall_s, launches=launches,
                          stats=dict(engine.runner.stats), loads=engine.loads(),
                          probe_text=probe.text, stop_d=stop_d, mask_ms=mask_ms)
        if with_profile and name == "graphs":
            runs[name]["penalty_ops_ms"] = penalty_ops_ms(dev, cfg.vocab_size)
            greedy = SP(temperature=0.0, max_new_tokens=128, ignore_eos=True)
            pen = SP(temperature=0.0, max_new_tokens=128, ignore_eos=True,
                     frequency_penalty=0.5, presence_penalty=0.3, repetition_penalty=1.3)
            forced = SP(temperature=0.0, max_new_tokens=128, ignore_eos=True, stop=[NEVER_STOP])
            runs[name]["profile"] = {
                "no_penalties": profile_decode(engine, loop, sampling=[greedy] * 4,
                                               label=f"[{label}] 4 lanes, no penalties"),
                "penalties": profile_decode(engine, loop, sampling=[pen] * 4,
                                            label=f"[{label}] 4 lanes, penalties"),
                "forced_k1": profile_decode(engine, loop, sampling=[forced] + [greedy] * 3,
                                            label=f"[{label}] 4 lanes, one stop-string lane"),
            }
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def check_requests(runs, L: int, label: str, card: str, strict: bool) -> dict:
    """Per-request checks on every path (counts, finishes, D cut at its
    stop string, E and F valid), launch counts, audits; greedy streams of
    A, B, D and E compared across paths (``strict``: all must be equal).
    Returns the agreement and the readings."""
    import re

    from smg_tpu_torch.constrained import JsonMachine
    from smg_tpu_torch.constrained.regex_fsm import RegexMachine

    rx = RegexMachine(REGEX_E)
    for name, r in runs.items():
        tag = f"{label}/{name}"
        res = r["results"]
        check_launches(r, L, f"{tag} requests", plain=name == "plain")
        audit = r["loads"]["audit"]
        if audit["leaked_pages"] or not audit["clean"]:
            raise AssertionError(f"[{tag}] audit not clean: {audit}")
        for rid in "ABC":
            if res[rid].output_tokens != 32 or res[rid].finish_reason != "length":
                raise AssertionError(f"[{tag}] {rid}: {res[rid]}")
        d, stop, probe = res["D"], r["stop_d"], r["probe_text"]
        want = probe[:probe.find(stop)]
        if (d.finish_reason != "stop" or d.matched_stop != stop or d.text != want
                or d.output_tokens > 13):
            raise AssertionError(f"[{tag}] D: stop {stop!r}, want text {want!r}, got {d}")
        for rid, ok, whole in (("E", rx.accepts, lambda t: rx.complete(t)
                                and re.fullmatch(REGEX_E, t) is not None),
                               ("F", JsonMachine().accepts, _json_parses)):
            x = res[rid]
            if not ok(x.text) or (x.finish_reason == "stop" and not whole(x.text)) or (
                    x.finish_reason != "stop" and (x.finish_reason, x.output_tokens)
                    != ("length", 16)):
                raise AssertionError(f"[{tag}] {rid}: invalid {x.text!r} ({x})")
        print(f"  [{tag}] " + "; ".join(
            f"{rid}: {x.output_tokens} tok, {x.finish_reason}, {x.text!r}"
            for rid, x in res.items()))

    def agree(a, b):
        return sum(runs[a]["results"][rid].token_ids == runs[b]["results"][rid].token_ids
                   for rid in "ABDE")

    pairs = (("graphs", "eager"), ("eager", "plain"), ("graphs", "plain"))
    out = dict(streams_equal={f"{a}_vs_{b}": agree(a, b) for a, b in pairs})
    print(f"  [{label}] greedy streams A, B, D, E equal (of 4): {out['streams_equal']}")
    if strict and set(out["streams_equal"].values()) != {4}:
        raise AssertionError(f"[{label}] greedy request streams differ: {out}")
    g = runs["graphs"]
    for kind, ms in g["mask_ms"].items():
        if not ms:
            raise AssertionError(f"[{label}] no {kind} mask was derived")
        out[f"mask_ms_{kind}"] = dict(n=len(ms), median=statistics.median(ms), max=max(ms),
                                      total_s=sum(ms) / 1e3)
    out["drive_wall_s"] = {name: r["wall_s"] for name, r in runs.items()}
    out["launches"] = {name: r["launches"] for name, r in runs.items()}
    out["mask_share_of_graph_drive"] = sum(map(sum, g["mask_ms"].values())) / 1e3 / g["wall_s"]
    print(f"  [{card}] {label} host ms per masked token (graph path, V=128256): " + ", ".join(
        f"{k[8:]} median {v['median']:.2f} max {v['max']:.2f} (n={v['n']})"
        for k, v in out.items() if k.startswith("mask_ms_"))
        + f"; masks {out['mask_share_of_graph_drive']:.3f} of the graph drive's "
          f"{g['wall_s']:.2f} s")
    if "profile" in g:
        p = g["profile"]
        out["profile"] = {k: {m: v[m] for m in ("device_ms_per_column", "wall_ms_per_column",
                                                "busy_share", "decode_tok_s", "columns",
                                                "launches", "replay_ms_per_column")
                              if m in v} for k, v in p.items()}
        a, b = p["no_penalties"], p["penalties"]
        out["penalty_ops_ms_per_column"] = g["penalty_ops_ms"]
        out["penalty_device_ms_per_column"] = (b["device_ms_per_column"]
                                               - a["device_ms_per_column"])
        out["forced_k1_host_share"] = 1.0 - p["forced_k1"]["busy_share"]
        print(f"  [{card}] {label} penalty work alone (B=8, K=4): "
              f"{g['penalty_ops_ms']:.4f} ms/column; penalties on 4 lanes: device "
              f"{b['device_ms_per_column']:.3f} vs {a['device_ms_per_column']:.3f} ms/column "
              f"({out['penalty_device_ms_per_column']:+.3f}), busy share "
              f"{b['busy_share']:.3f} vs {a['busy_share']:.3f}, "
              f"{b['decode_tok_s']:.2f} vs {a['decode_tok_s']:.2f} tokens/s; forced K=1: "
              f"wall {p['forced_k1']['wall_ms_per_column']:.2f} ms/column, host share "
              f"{out['forced_k1_host_share']:.3f}")
    return out


def _json_parses(text: str) -> bool:
    try:
        json.loads(text)
        return True
    except ValueError:
        return False


# ---- phase 5: the serving entry, the port's gateway over HTTP ----

SERVE_MODEL = "llama3-8b"
SERVE_WORKER = "inproc-0"


def _http(port: int, method: str, path: str, body=None, headers=None):
    """One request with the standard library; returns (status, JSON body or
    text)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=LOOP_WAIT_S) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    text = raw.decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def _sse(port: int, path: str, body: dict, headers=None) -> tuple[int, list]:
    """A streamed request: (status, [(seconds since the request was sent,
    payload)]) for every ``data:`` frame, ``[DONE]`` as the string."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    frames = []
    with urllib.request.urlopen(req, timeout=LOOP_WAIT_S) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                data = line[len("data: "):]
                frames.append((time.perf_counter() - t0,
                               data if data == "[DONE]" else json.loads(data)))
        return resp.status, frames


def _words(ids) -> str:
    return " ".join(f"w{i}" for i in ids)  # MockTokenizer: w<id> <-> id


def _chat(ids, max_new: int, **kw) -> dict:
    return {"model": SERVE_MODEL, "messages": [{"role": "user", "content": _words(ids)}],
            "max_tokens": max_new, "temperature": 0, "ignore_eos": True, **kw}


def _sse_text(frames) -> tuple[str, str | None, dict | None]:
    """(content, finish reason, usage) of a chat stream's frames."""
    text, finish, usage = "", None, None
    for _t, f in frames:
        if f == "[DONE]":
            continue
        for c in f["choices"]:
            text += c["delta"].get("content") or ""
            finish = c.get("finish_reason") or finish
        usage = f.get("usage") or usage
    return text, finish, usage


def _serve_jobs(seed: int, tok) -> dict:
    """Prompts of every phase-5 request, as token ids; ``chat`` entries are
    the ids the gateway's chat template gives a message of those words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    shared = ids(600)
    return dict(
        chat32=ids(40), comp1400=ids(1400), gen1400=ids(1400),
        shared_a=shared + ids(40), shared_b=shared + ids(60),
        conc=[ids(int(n)) for n in rng.integers(60, 300, 8)],
        ok=[ids(80), ids(80)], poison=ids(80), dec=[ids(100) for _ in range(4)])


def _chat_ids(tok, ids) -> list:
    msg = [{"role": "user", "content": _words(ids)}]
    return tok.encode(tok.apply_chat_template(msg, add_generation_prompt=True))


def _direct(engine, jobs) -> dict:
    """Submit ``jobs`` = [(rid, prompt ids, max_new)] to the engine's loop
    together, greedy; returns rid -> (token ids, finish, cached tokens,
    seconds to the first output, [(seconds between outputs, tokens)])."""
    from smg_tpu_torch.protocols.sampling import SamplingParams

    outs = {rid: [] for rid, _, _ in jobs}
    t0 = {}
    for rid, prompt, n in jobs:
        t0[rid] = time.perf_counter()
        engine.submit(prompt, SamplingParams(temperature=0.0, max_new_tokens=n,
                                             ignore_eos=True), rid=rid,
                      on_output=lambda o, rid=rid: outs[rid].append((time.perf_counter(), o)))
    wait_for(lambda: all(c and c[-1][1].finished for c in outs.values()), "direct requests")
    res = {}
    for rid, c in outs.items():
        times = [t for t, _o in c]
        res[rid] = ([t for _t, o in c for t in o.new_token_ids], c[-1][1].finish_reason,
                    c[0][1].cached_tokens, times[0] - t0[rid],
                    [(b - a, len(o.new_token_ids)) for a, b, (_t, o)
                     in zip(times, times[1:], c[1:])])
    return res


def _in_threads(fn, args_list) -> list:
    """Run ``fn(*args)`` for every entry on its own thread; results in order."""
    import threading

    out = [None] * len(args_list)
    errs = []

    def run(i, args):
        try:
            out[i] = fn(*args)
        except Exception as e:  # surfaced below, after every thread ended
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(LOOP_WAIT_S)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errs}")
    return out


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def phase_serve(cfg, params, dev, card: str, label: str, strict: bool) -> dict:
    """Phase 5 (``_phase_serve``) with its engine and gateway built, and
    every request served, under the lock-order sentinel: the engine, flight
    recorder, breaker, worker, registry, SLO and route-observability locks
    are watched, and the sentinel's exit raises on any inversion."""
    from smg_tpu_torch.analysis import lock_order_sentinel

    with lock_order_sentinel() as sentinel:
        out = _phase_serve(cfg, params, dev, card, label, strict)
    out["lock_inversions"] = len(sentinel.inversions)
    print(f"  [{label}] phase 5: {out['lock_inversions']} lock-order inversions")
    return out


def _phase_serve(cfg, params, dev, card: str, label: str, strict: bool) -> dict:
    """The serving entry on Llama-3-8B at full width and depth: the port's
    gateway (``cache_aware``, one in-process worker over an ``Engine`` with
    CUDA graphs, the overlap pipeline and the loop thread, phase 3's cache
    and scheduler settings) served on a free local port, every request sent
    with ``urllib``.  Each request is first submitted directly to the same
    engine (prefix cache flushed before each group, as it is before the
    same group over HTTP): with ``strict`` (float32) the HTTP path's tokens
    must equal those, otherwise their agreement is printed.  Kernel launch
    counters are zeroed just before the HTTP requests and read just after."""
    import asyncio
    import gc
    import socket
    import threading

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.faults import FAULTS
    from smg_tpu_torch.gateway.launch import build_context, serve_context
    from smg_tpu_torch.tokenizer import MockTokenizer

    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    engine = Engine(EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                  max_prefill_tokens=512, decode_horizon=4),
        model_id=SERVE_MODEL), params=params, device=dev, tokenizer=tok)
    ctx = build_context(engine, policy="cache_aware")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    held = {}

    async def serve():
        held["loop"], held["stop"] = asyncio.get_running_loop(), asyncio.Event()
        await serve_context(ctx, "127.0.0.1", port, held["stop"])

    server = threading.Thread(target=lambda: asyncio.run(serve()), name="gateway")
    server.start()
    out: dict = {}
    try:
        wait_for(lambda: "stop" in held, "gateway start", timeout=60)
        deadline = time.monotonic() + 60
        while True:
            try:
                if _http(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                if time.monotonic() > deadline:
                    raise
            time.sleep(0.05)
        out = _serve_checks(engine, tok, port, label, strict, card)
        # the cache-aware policy routed over the native radix tree: a failed
        # build of the index on this host fails the phase
        tree = type(ctx.policies.policy_for(SERVE_MODEL).tree).__name__
        out["radix_tree"] = tree
        if tree != "NativeRadixTree":
            raise AssertionError(f"[{label}] cache_aware routes over {tree}, not the native "
                                 "tree: the index did not build or load on this host")
    finally:
        if "stop" in held:
            held["loop"].call_soon_threadsafe(held["stop"].set)
        server.join(LOOP_WAIT_S)
        FAULTS.clear()
    if server.is_alive():
        raise AssertionError("the gateway did not shut down")
    # aiohttp keeps finished apps in a module-level cache, with their
    # contexts: the worker goes, so the engine's weights and KV can
    ctx.registry.remove(SERVE_WORKER)
    del engine, ctx
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_checks(engine, tok, port: int, label: str, strict: bool, card: str) -> dict:
    """Phase 5's requests and checks against a served ``engine``; raises
    after printing every failed check."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from smg_tpu_torch.faults import FAULTS
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    L = engine.config.model.num_layers
    jobs = _serve_jobs(17, tok)
    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [{label}] CHECK FAILED: {what}")

    def flush_direct():
        if not engine.flush_cache():
            raise AssertionError("flush_cache refused on an idle engine")

    # warm-up (cuBLAS, the allocator, first graphs); not counted
    engine.generate(list(range(1000, 1100)), SamplingParams(temperature=0.0, max_new_tokens=8))
    # ---- direct references on the same engine ----
    ref = {}
    flush_direct()
    ref.update(_direct(engine, [("chat32", _chat_ids(tok, jobs["chat32"]), 32)]))
    flush_direct()
    ref.update(_direct(engine, [("comp1400", tok.encode(_words(jobs["comp1400"])), 16)]))
    flush_direct()
    ref.update(_direct(engine, [("gen1400", jobs["gen1400"], 16)]))
    flush_direct()
    for rid in ("shared_a", "shared_b"):
        ref.update(_direct(engine, [(rid, _chat_ids(tok, jobs[rid]), 16)]))
    conc_ids = [_chat_ids(tok, p) for p in jobs["conc"]]
    for i, ids in enumerate(conc_ids):  # each alone
        flush_direct()
        ref.update(_direct(engine, [(f"conc{i}", ids, 32)]))
    flush_direct()
    together = _direct(engine, [(f"tog{i}", ids, 32) for i, ids in enumerate(conc_ids)])
    for i, p in enumerate(jobs["ok"]):
        flush_direct()
        ref.update(_direct(engine, [(f"ok{i}", _chat_ids(tok, p), 16)]))
    for i, p in enumerate(jobs["dec"]):
        flush_direct()
        ref.update(_direct(engine, [(f"dec{i}", _chat_ids(tok, p), 32)]))
    agree = {}

    def same(name, got_ids_or_text, rid):
        want = ref[rid][0]
        ok = (got_ids_or_text == want if isinstance(got_ids_or_text, list)
              else got_ids_or_text == tok.decode(want))
        agree.setdefault(name, [0, 0])
        agree[name][0] += int(ok)
        agree[name][1] += 1
        if strict:
            expect(ok, f"{rid} over HTTP differs from the direct engine")

    def flush_http():
        st, body = _http(port, "POST", "/flush_cache")
        if st != 200 or body["flushed"].get(SERVE_WORKER) is not True:
            raise AssertionError(f"/flush_cache: {st} {body}")

    # ---- the HTTP path: counters zeroed just before, read just after ----
    for k in engine.runner.stats:
        engine.runner.stats[k] = 0
    torch.cuda.synchronize()
    dk.launches = 0
    pk.launches = 0
    t_http = time.perf_counter()
    # 1. probes
    st, health = _http(port, "GET", "/health")
    expect(st == 200 and health.get("status") == "ok", f"/health {st}")
    st, models = _http(port, "GET", "/v1/models")
    expect(st == 200 and SERVE_MODEL in [m["id"] for m in models["data"]], f"/v1/models {models}")
    # 2. greedy chat, then the same chat streamed
    flush_http()
    st, chat = _http(port, "POST", "/v1/chat/completions", _chat(jobs["chat32"], 32))
    expect(st == 200, f"chat status {st}")
    content = chat["choices"][0]["message"]["content"]
    same("chat", content, "chat32")
    flush_http()
    st, frames = _sse(port, "/v1/chat/completions", _chat(
        jobs["chat32"], 32, stream=True, stream_options={"include_usage": True}))
    text, finish, usage = _sse_text(frames)
    expect(st == 200 and frames[-1][1] == "[DONE]", "stream did not end in [DONE]")
    expect(finish == chat["choices"][0]["finish_reason"] == "length", f"finish {finish}")
    expect(usage and all(usage[k] == chat["usage"][k] for k in
                         ("prompt_tokens", "completion_tokens", "total_tokens")),
           f"stream usage {usage} != {chat['usage']}")
    agree["stream_vs_nonstream"] = [int(text == content), 1]
    if strict:
        expect(text == content, "streamed deltas differ from the non-streaming content")
    ttft_alone = frames[0][0]
    ttft = []
    # 3. a 1400-token prompt through /v1/completions and /generate: three
    # prefill chunks, so the prefill kernel runs with prefix_len > 0
    flush_http()
    st, comp = _http(port, "POST", "/v1/completions", {
        "model": SERVE_MODEL, "prompt": _words(jobs["comp1400"]), "max_tokens": 16,
        "temperature": 0, "ignore_eos": True})
    expect(st == 200 and comp["usage"]["completion_tokens"] == 16, f"completions {st}")
    same("completions", comp["choices"][0]["text"], "comp1400")
    flush_http()
    st, gen = _http(port, "POST", "/generate", {
        "input_ids": jobs["gen1400"],
        "sampling_params": {"max_new_tokens": 16, "temperature": 0, "ignore_eos": True}})
    expect(st == 200 and len(gen["output_ids"]) == 16, f"/generate {st}")
    same("generate", gen["output_ids"], "gen1400")
    # 4. a shared 600-token prefix: the second request's radix hit
    flush_http()
    cached = []
    for rid in ("shared_a", "shared_b"):
        st, r = _http(port, "POST", "/v1/chat/completions", _chat(jobs[rid], 16))
        expect(st == 200, f"{rid} status {st}")
        same("shared_prefix", r["choices"][0]["message"]["content"], rid)
        cached.append((r["usage"].get("prompt_tokens_details") or {}).get("cached_tokens", 0))
    expect(cached[1] >= 592 and cached[1] == ref["shared_b"][2],
           f"shared_b cached {cached[1]} (direct {ref['shared_b'][2]})")
    # 5. eight concurrent streaming chats, under the profiler
    flush_http()
    # the profiler starts and stops under the engine lock: never while the
    # loop thread captures a graph (as in profile_decode)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with engine._lock:
        prof.start()
    t0 = time.perf_counter()
    streams = _in_threads(lambda p: _sse(port, "/v1/chat/completions", _chat(p, 32, stream=True)),
                          [(p,) for p in jobs["conc"]])
    with engine._lock:
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        prof.stop()
    busy_ms, _by_name, _n = device_time(prof)
    alone_equal = 0
    gaps, per_token = [], []
    for i, (st, frames) in enumerate(streams):
        text, finish, _u = _sse_text(frames)
        expect(st == 200 and frames[-1][1] == "[DONE]" and finish == "length",
               f"conc{i}: {st} {finish}")
        expect(len(text.split()) <= 32 and text, f"conc{i} text")
        alone_equal += int(text == tok.decode(ref[f"conc{i}"][0]))
        ttft.append(frames[0][0])
        body = [(t, f) for t, f in frames if f != "[DONE]" and f["choices"]]
        for (a, _fa), (b, fb) in zip(body, body[1:]):
            n = len((fb["choices"][0]["delta"].get("content") or "").split()) or 1
            gaps.append((b - a) * 1e3)
            per_token.append((b - a) * 1e3 / n)
    st, sched = _http(port, "GET", "/scheduler")
    audit = sched["engine"][SERVE_WORKER]["audit"]
    expect(st == 200 and audit["clean"], f"audit after the concurrent streams: {audit}")
    direct_gaps = [g * 1e3 for r in together.values() for g, _n in r[4]]
    direct_per_token = [g * 1e3 / max(n, 1) for r in together.values() for g, n in r[4]]
    direct_ttft = [r[3] for r in together.values()]
    # 6. faults: a poisoned prefill among three, then a decode step in a
    # 4-lane batch
    flush_http()
    poison_rid = f"poison-{label}"
    FAULTS.arm("engine.prefill", match=poison_rid)
    q0 = engine.scheduler.num_quarantined
    res = _in_threads(lambda body, hdr: _http(port, "POST", "/v1/chat/completions", body, hdr),
                      [(_chat(jobs["ok"][0], 16), None), (_chat(jobs["ok"][1], 16), None),
                       (_chat(jobs["poison"], 16), {"X-Request-Id": poison_rid})])
    FAULTS.clear()
    for i in range(2):
        expect(res[i][0] == 200 and res[i][1]["choices"][0]["finish_reason"] == "length",
               f"ok{i} under a poisoned prefill: {res[i]}")
        same("prefill_fault_survivors", res[i][1]["choices"][0]["message"]["content"], f"ok{i}")
    expect(res[2][0] == 200 and res[2][1]["choices"][0]["finish_reason"] == "error",
           f"poisoned request: {res[2]}")
    flush_http()
    dec_rids = [f"dec-{label}-{i}" for i in range(4)]
    sched_reqs = engine.scheduler.requests
    armed = {}

    def arm_when_running():
        wait_for(lambda: all(getattr(dict(sched_reqs).get(r), "status", None) is not None
                             and dict(sched_reqs)[r].status.value == "running"
                             for r in dec_rids), "the 4 decode lanes", timeout=60)
        reqs = dict(sched_reqs)
        armed["newest"] = max(dec_rids, key=lambda r: reqs[r].sched_serial)
        FAULTS.arm("engine.decode_step", mode="once")

    arm = threading.Thread(target=arm_when_running, name="arm-fault")
    arm.start()
    res = _in_threads(lambda body, hdr: _http(port, "POST", "/v1/chat/completions", body, hdr),
                      [(_chat(p, 32), {"X-Request-Id": r}) for p, r in zip(jobs["dec"], dec_rids)])
    arm.join(LOOP_WAIT_S)
    FAULTS.clear()
    finishes = {r: b["choices"][0]["finish_reason"] for r, (_s, b) in zip(dec_rids, res)}
    expect(armed.get("newest") and finishes[armed["newest"]] == "error"
           and sum(f == "error" for f in finishes.values()) == 1,
           f"decode fault: finishes {finishes}, newest {armed.get('newest')}")
    for i, r in enumerate(dec_rids):
        if r != armed.get("newest"):
            same("decode_fault_survivors", res[i][1]["choices"][0]["message"]["content"],
                 f"dec{i}")
    quarantined = engine.scheduler.num_quarantined - q0
    expect(quarantined == 2, f"{quarantined} quarantines, expected 2")
    st, _h = _http(port, "GET", "/health")
    expect(st == 200, f"/health after the faults: {st}")
    st, dump = _http(port, "GET", f"/debug/flight/{SERVE_WORKER}?reason=quarantine")
    flags = {f for rec in dump["dump"]["ring"] for f in rec["faults"]} if st == 200 else set()
    expect(st == 200 and {"prefill", "decode"} <= flags
           and dump["dump"]["last_auto_dump"]["reason"] == "quarantine",
           f"flight dump: {st}, fault flags {flags}")
    # 7. /metrics: the engine's families beside the gateway's
    st, metrics = _http(port, "GET", "/metrics")
    expect(st == 200 and "smg_engine_quarantined_requests_total "
           f"{float(engine.scheduler.num_quarantined)}" in metrics,
           "quarantine counter on /metrics")
    for fam in ("smg_engine_step_duration_seconds", "smg_engine_decode_tokens_total",
                "smg_engine_kv_free_pages", 'smg_requests_total{route="/v1/chat/completions",status="200"}',
                "smg_time_to_first_token_seconds", "smg_generated_tokens_total"):
        expect(fam in metrics, f"/metrics lacks {fam}")
    http_s = time.perf_counter() - t_http
    # 8. launches through the HTTP path: exact
    torch.cuda.synchronize()
    launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
    stats = dict(engine.runner.stats)
    want = {"decode_attention": L * stats["decode_columns"],
            "prefill_attention": L * stats["prefill_calls"]}
    expect(launches == want and min(launches.values()) > 0,
           f"launches {launches} != {want}")
    out = dict(
        launches=launches, schedule=stats, http_s=http_s, agreement=agree,
        concurrent_equal_alone=[alone_equal, len(jobs["conc"])],
        ttft_alone_ms=ttft_alone * 1e3,
        ttft_ms={"median": statistics.median(ttft) * 1e3, "max": max(ttft) * 1e3},
        frame_gap_ms={"median": statistics.median(gaps), "p95": _pct(gaps, 95)},
        token_gap_ms={"median": statistics.median(per_token), "p95": _pct(per_token, 95)},
        direct_ttft_ms={"median": statistics.median(direct_ttft) * 1e3,
                        "max": max(direct_ttft) * 1e3},
        direct_output_gap_ms={"median": statistics.median(direct_gaps),
                              "p95": _pct(direct_gaps, 95)},
        direct_token_gap_ms={"median": statistics.median(direct_per_token),
                             "p95": _pct(direct_per_token, 95)},
        busy_share=busy_ms / window_ms, window_ms=window_ms, quarantined=quarantined,
        shared_b_cached=cached[1])
    out["gateway_ms_per_token"] = (out["token_gap_ms"]["median"]
                                   - out["direct_token_gap_ms"]["median"])
    print(f"  [{card}] {label} HTTP path: TTFT of the chat alone {ttft_alone * 1e3:.2f} ms; "
          f"of the 8 concurrent streams median {out['ttft_ms']['median']:.2f} ms, "
          f"max {out['ttft_ms']['max']:.2f} ms; SSE frame gap median "
          f"{out['frame_gap_ms']['median']:.2f} ms, p95 {out['frame_gap_ms']['p95']:.2f} ms; "
          f"per token median {out['token_gap_ms']['median']:.3f} ms, p95 "
          f"{out['token_gap_ms']['p95']:.3f} ms")
    print(f"  [{card}] {label} direct Engine callbacks: TTFT median "
          f"{out['direct_ttft_ms']['median']:.2f} ms, max {out['direct_ttft_ms']['max']:.2f} ms; "
          f"output gap median {out['direct_output_gap_ms']['median']:.2f} ms, p95 "
          f"{out['direct_output_gap_ms']['p95']:.2f} ms; per token median "
          f"{out['direct_token_gap_ms']['median']:.3f} ms; gateway cost per token "
          f"{out['gateway_ms_per_token']:.3f} ms")
    print(f"  [{card}] {label} concurrent window {window_ms:.1f} ms, device busy share "
          f"{out['busy_share']:.3f}; 8 streams equal alone: {alone_equal}/8; agreement "
          f"with the direct engine: {agree}; launches {launches} (expected {want}); "
          f"quarantines {quarantined}; shared_b cached {cached[1]}")
    if failures:
        raise AssertionError(f"[{label}] serving checks failed: {failures}")
    return out


# ---- phase 6: the request-policy layer over HTTP ----

API_KEY = "sk-smoke"
PREEMPT_TOKENS = 200  # the bulk chat a system chat preempts
# a decode the request timeout cuts: long enough to outlast TIMEOUT_S at any depth
TIMEOUT_TOKENS, TIMEOUT_S = 1000, 1.0
SLO_TOLERANCE = 0.05  # /debug/slo p50s against the client's, TTFT from dispatch
# scripted outputs: the i-th piece is what the i-th greedy token of the
# request's prompt decodes to (``ScriptTokenizer``)
TOOL_PIECES = ("<|python_tag|>", '{"name": "get_weather", ', '"parameters": {"city": ',
               '"Paris", "unit": "c"}}')
THINK_PIECES = ("<think>", "weigh the ", "options", "</think>", "The answer is 4.")
HARMONY_PIECES = ("<|channel|>analysis<|message|>", "thinking hard", "<|end|>",
                  "<|start|>assistant<|channel|>final<|message|>", "It is sunny.")
WEATHER_TOOL = {"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    "parameters": {"type": "object", "required": ["city"], "properties": {
        "city": {"type": "string"}, "unit": {"type": "string", "enum": ["c", "f"]}}}}}


class ScriptTokenizer:
    """The gateway's tokenizer for phase 6's parser checks, a test harness
    and not part of the port: ``MockTokenizer``'s encoding and chat
    template, and a decode that maps each id of ``script`` to its piece and
    every other id to nothing (``script`` is set before each request)."""

    def __init__(self, base):
        self.base = base
        self.eos_token_id = base.eos_token_id
        self.script: dict[int, str] = {}

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        return self.base.encode(text, add_special_tokens)

    def apply_chat_template(self, messages, add_generation_prompt: bool = True, **kw) -> str:
        return self.base.apply_chat_template(messages, add_generation_prompt, **kw)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(self.script.get(int(t), "") for t in ids)


class Collector:
    """An in-process OTLP/HTTP collector: the spans every export carried."""

    def __init__(self):
        from aiohttp import web

        self.spans: list = []
        self.app = web.Application()
        self.app.router.add_post("/v1/traces", self.handle)

    async def handle(self, request):
        from aiohttp import web

        for rs in (await request.json())["resourceSpans"]:
            for ss in rs["scopeSpans"]:
                self.spans.extend(ss["spans"])
        return web.json_response({})


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gateways(engine, specs: dict) -> dict:
    """name -> ``AppContext`` over ``engine``, each built from ``serve``
    flags the way ``python -m smg_tpu_torch.cli serve`` builds its own."""
    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import build_context, gateway_options

    out = {}
    for name, flags in specs.items():
        args = build_parser().parse_args(["serve", "--model-preset", SERVE_MODEL, *flags])
        out[name] = build_context(engine, **gateway_options(args))
    return out


def _policy_flags(slo_path: str, collector_port: int) -> dict:
    return {
        "bare": [],
        # every layer on: auth, a (generous) rate limit, priority admission,
        # the request timeout, CORS, SLO specs and OTel export
        "full": ["--api-key", f"{API_KEY}:smoke", "--priority-scheduler-enabled",
                 "--priority-slots", "64", "--rate-limit-tokens-per-second", "1000",
                 "--rate-limit-burst", "1000", "--request-timeout-secs", "600",
                 "--cors-allowed-origins", "https://app.example", "--slo-spec", slo_path,
                 "--otel-endpoint", f"http://127.0.0.1:{collector_port}"],
        "burst": ["--rate-limit-tokens-per-second", "1e-6", "--rate-limit-burst", "2",
                  "--trust-tenant-header"],
        "prio": ["--priority-scheduler-enabled", "--priority-slots", "1"],
        "timeout": ["--request-timeout-secs", str(TIMEOUT_S)],
        "parse": ["--reasoning-parser", "qwen3"],
        "harmony": ["--harmony", "on"],
    }


def phase_policy(cfg, params, dev, card: str, label: str, strict: bool, bare: dict) -> dict:
    """The request-policy layer over HTTP, after phase 5 on the same
    weights with phase 5's engine settings: one ``Engine`` (graphs, the
    overlap pipeline, the loop thread, horizon 4) behind seven gateways
    built from ``serve`` flags and served on free local ports from one
    event loop, and an in-process OTLP collector on a loop of its own.
    ``bare`` is phase 5's result on this dtype, printed beside this
    phase's readings."""
    import asyncio
    import gc
    import tempfile
    import threading

    import torch
    from aiohttp import web

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.gateway.server import build_app
    from smg_tpu_torch.tokenizer import MockTokenizer

    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    engine = Engine(EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                  max_prefill_tokens=512, decode_horizon=4),
        model_id=SERVE_MODEL), params=params, device=dev, tokenizer=tok)
    collector = Collector()
    col_port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        slo_path = str(Path(tmp) / "slo.json")
        # one spec every run passes, one no run can (a TTFT p95 of 1 us)
        Path(slo_path).write_text(json.dumps([
            {"name": "lenient", "ttft_p95_s": 60.0, "itl_p95_s": 10.0, "min_requests": 8,
             "hysteresis": 1},
            {"name": "strict", "ttft_p95_s": 1e-6, "min_requests": 8, "hysteresis": 1}]))
        ctxs = _gateways(engine, _policy_flags(slo_path, col_port))
    script_tok = ScriptTokenizer(tok)
    for name in ("parse", "harmony"):
        ctxs[name].tokenizers.register(SERVE_MODEL, script_tok, default=True)
    ports = {name: _free_port() for name in ctxs}
    # the gateways on one event loop, the collector on a loop of its own, as
    # a collector would be
    loops = {"gateways": {}, "collector": {}}

    async def serve(held: dict, apps: list):
        held["loop"], held["stop"] = asyncio.get_running_loop(), asyncio.Event()
        runners = []
        try:
            for app, port in apps:
                runner = web.AppRunner(app)
                await runner.setup()
                runners.append(runner)
                await web.TCPSite(runner, "127.0.0.1", port).start()
            held["up"] = True
            await held["stop"].wait()
        finally:
            for runner in reversed(runners):
                await runner.cleanup()

    apps = {"collector": [(collector.app, col_port)],
            "gateways": [(build_app(ctxs[n]), ports[n]) for n in ctxs]}
    servers = [threading.Thread(target=lambda n=n: asyncio.run(serve(loops[n], apps[n])), name=n)
               for n in loops]
    for t in servers:
        t.start()
    out: dict = {}
    try:
        wait_for(lambda: all("up" in h for h in loops.values())
                 or not all(t.is_alive() for t in servers), "gateways start", timeout=60)
        if not all("up" in h for h in loops.values()):
            raise AssertionError("the gateways did not start")
        out = _policy_checks(engine, tok, script_tok, ctxs, ports, collector,
                             loops["gateways"]["loop"], label, strict, card, bare)
    finally:
        for h in loops.values():
            if "stop" in h:
                h["loop"].call_soon_threadsafe(h["stop"].set)
        for t in servers:
            t.join(LOOP_WAIT_S)
        engine.stop(drain=True, timeout=30)
    if any(t.is_alive() for t in servers):
        raise AssertionError("the gateways did not shut down")
    # aiohttp keeps finished apps in a module-level cache, with their
    # contexts: the workers go, so the engine's weights and KV can
    for ctx in ctxs.values():
        ctx.registry.remove(SERVE_WORKER)
    del engine, ctxs, apps, servers, loops
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _client_slo(frames) -> tuple[float, float]:
    """(TTFT, per-token ITL) of one stream as the client saw it: the first
    frame's time, and the span from the first frame to the last over the
    tokens after the first frame (its words; the first carries at least
    one token)."""
    body = [(t, f) for t, f in frames if f != "[DONE]" and f["choices"]]
    first = len((body[0][1]["choices"][0]["delta"].get("content") or "").split()) or 1
    total = sum(len((f["choices"][0]["delta"].get("content") or "").split()) for _t, f in body)
    return body[0][0], (body[-1][0] - body[0][0]) / max(total - first, 1)


def _policy_checks(engine, tok, script_tok, ctxs, ports, collector, loop, label: str,
                   strict: bool, card: str, bare: dict) -> dict:
    """Phase 6's requests and checks; raises after printing every failed
    check."""
    import asyncio
    import threading

    import torch

    from smg_tpu_torch.gateway.harmony import render_harmony_prompt
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    L = engine.config.model.num_layers
    jobs = _serve_jobs(17, tok)  # phase 5's prompts
    auth = {"Authorization": f"Bearer {API_KEY}"}
    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [{label}] CHECK FAILED: {what}")

    def flush_direct():
        if not engine.flush_cache():
            raise AssertionError("flush_cache refused on an idle engine")

    def settled_audit() -> dict:
        # a client can hold its whole response before the engine thread has
        # dropped the request's output callback; a leak outlasts the wait
        try:
            wait_for(lambda: engine.audit()["clean"], "a clean audit", timeout=10)
        except TimeoutError:
            pass
        return engine.audit()

    def aborts() -> tuple[float, float]:
        fin = engine.metrics.requests_finished
        return (fin.labels(reason="abort")._value.get(),
                fin.labels(reason="timeout")._value.get())

    engine.generate(list(range(1000, 1100)), SamplingParams(temperature=0.0, max_new_tokens=8))
    # ---- direct references on the same engine ----
    ref = {}
    flush_direct()
    ref.update(_direct(engine, [("chat32", _chat_ids(tok, jobs["chat32"]), 32)]))
    bulk_ids = jobs["comp1400"][:120]
    flush_direct()
    # twice: the preempted run leaves the prompt's pages in the prefix cache,
    # so its rerun is compared with a run that finds them there too
    for rid in ("bulk_first", "bulk"):
        ref.update(_direct(engine, [(rid, _chat_ids(tok, bulk_ids), PREEMPT_TOKENS)]))
    conc_ids = [_chat_ids(tok, p) for p in jobs["conc"]]
    flush_direct()
    together = _direct(engine, [(f"tog{i}", ids, 32) for i, ids in enumerate(conc_ids)])
    # prompts whose first k greedy ids are pairwise distinct, one per script
    # (random weights can repeat an id, and a repeated id would decode to
    # its piece twice)
    import numpy as np

    rng = np.random.default_rng(29)
    scripts = {}
    for name, pieces in (("tool", TOOL_PIECES), ("think", THINK_PIECES),
                         ("harmony", HARMONY_PIECES)):
        for attempt in range(8):
            words = _words(rng.integers(1000, 120000, 24).tolist())
            msgs = [{"role": "user", "content": words}]
            if name == "harmony":
                prompt = tok.encode(render_harmony_prompt(msgs, reasoning_effort="medium"))
            else:
                prompt = tok.encode(tok.apply_chat_template(msgs, add_generation_prompt=True))
            flush_direct()
            ids = _direct(engine, [(f"{name}{attempt}", prompt, len(pieces))])[
                f"{name}{attempt}"][0]
            if len(set(ids)) == len(pieces):
                scripts[name] = (words, dict(zip(ids, pieces)))
                break
        else:
            raise AssertionError(f"no prompt with {len(pieces)} distinct greedy ids for {name}")

    def flush_http(name: str = "full"):
        st, body = _http(ports[name], "POST", "/flush_cache", headers=auth)
        if st != 200 or body["flushed"].get(SERVE_WORKER) is not True:
            raise AssertionError(f"/flush_cache: {st} {body}")

    # ---- the HTTP path: counters zeroed just before, read just after ----
    for k in engine.runner.stats:
        engine.runner.stats[k] = 0
    torch.cuda.synchronize()
    dk.launches = 0
    pk.launches = 0
    t_http = time.perf_counter()
    full, chat = ports["full"], "/v1/chat/completions"
    # 1. auth: no key 401, an unknown key 403 (the reference's answers),
    # the key 200 with phase 5's lone-chat tokens
    st_none = _http(full, "POST", chat, _chat(jobs["chat32"], 32))[0]
    st_wrong = _http(full, "POST", chat, _chat(jobs["chat32"], 32),
                     {"Authorization": "Bearer sk-wrong"})[0]
    expect(st_none == 401 and st_wrong == 403, f"auth: no key {st_none}, wrong key {st_wrong}")
    flush_http()
    st, body = _http(full, "POST", chat, _chat(jobs["chat32"], 32), auth)
    agree = {"auth_chat": int(st == 200 and body["choices"][0]["message"]["content"]
                              == tok.decode(ref["chat32"][0]))}
    expect(st == 200, f"chat with the key: {st}")
    if strict:
        expect(agree["auth_chat"], "the authenticated chat differs from the direct engine")
    # 2. the added TTFT of the lone chat: streamed through the bare and the
    # full gateway in turns, the prefix cache flushed before each
    lone = {"bare": [], "full": []}
    for name in ("bare", "full", "full", "bare") * 4:
        flush_http()
        st, frames = _sse(ports[name], chat, _chat(jobs["chat32"], 32, stream=True),
                          auth if name == "full" else None)
        expect(st == 200 and frames[-1][1] == "[DONE]", f"lone stream via {name}: {st}")
        lone[name].append(frames[0][0] * 1e3)
    # 3. rate limit: burst 2, near-zero refill, three concurrent chats of
    # one tenant: exactly one 429
    res = _in_threads(lambda: _http(ports["burst"], "POST", chat, _chat(jobs["ok"][0], 8),
                                    {"X-Tenant-Id": "burst"}), [()] * 3)
    codes = sorted(r[0] for r in res)
    inflight = dict(ctxs["burst"].rate_limiter._inflight)
    expect(codes == [200, 200, 429] and not any(inflight.values()),
           f"rate limit: {codes}, in flight after {inflight}")
    # 4. preemption: a bulk chat holds the only slot when a system chat
    # arrives; the bulk run is aborted in the engine, requeued and rerun
    flush_http()
    free0 = engine.scheduler.pool.free_count
    a0 = aborts()
    bulk_rid = f"bulk-{label}"
    got = {}

    def run_bulk():
        got["bulk"] = _http(ports["prio"], "POST", chat, _chat(bulk_ids, PREEMPT_TOKENS),
                            {"X-SMG-Priority": "bulk", "X-Request-Id": bulk_rid})
        got["bulk_done"] = time.perf_counter()

    bulk_thread = threading.Thread(target=run_bulk, name="bulk")
    bulk_thread.start()
    reqs = engine.scheduler.requests
    wait_for(lambda: len(getattr(dict(reqs).get(bulk_rid), "output_ids", ())) >= 16,
             "the bulk chat decoding", timeout=60)
    st, frames = _sse(ports["prio"], chat, _chat(jobs["ok"][1], 8, stream=True),
                      {"X-SMG-Priority": "system"})
    sys_done = time.perf_counter()
    preempt_ms = frames[0][0] * 1e3
    bulk_thread.join(LOOP_WAIT_S)
    st_b, body_b = got.get("bulk", (None, None))
    d_abort = aborts()[0] - a0[0]
    stats = ctxs["prio"].priority.stats["bulk"]
    expect(st == 200 and frames[-1][1] == "[DONE]" and st_b == 200,
           f"preemption: system {st}, bulk {st_b}")
    expect(sys_done < got.get("bulk_done", 0.0), "the system chat did not finish first")
    expect(d_abort == 1 and stats["preempted"] == 1,
           f"preemption: {d_abort} engine aborts, scheduler stats {stats}")
    bulk_text = body_b["choices"][0]["message"]["content"] if st_b == 200 else None
    agree["preempted_bulk"] = int(bulk_text == tok.decode(ref["bulk"][0]))
    if strict:
        expect(agree["preempted_bulk"], "the preempted bulk chat differs from its lone run")
    audit = settled_audit()
    flush_http()
    free1 = engine.scheduler.pool.free_count
    expect(audit["clean"] and free1 == free0,
           f"after preemption: audit {audit}, free pages {free1} != {free0}")
    # 5. the request timeout: a TIMEOUT_TOKENS decode cut at TIMEOUT_S, not
    # streamed (408 before any byte) and streamed (the stream is cut)
    a0 = aborts()
    t0 = time.perf_counter()
    st_t, _b = _http(ports["timeout"], "POST", chat, _chat(jobs["ok"][0], TIMEOUT_TOKENS))
    cut_s = time.perf_counter() - t0
    cut_frames, cut_err = _sse_cut(ports["timeout"], _chat(jobs["ok"][1], TIMEOUT_TOKENS,
                                                           stream=True))
    wait_for(lambda: not engine.has_work(), "the timed-out requests to end", timeout=60)
    a1 = aborts()
    ended = (a1[0] - a0[0], a1[1] - a0[1])
    audit = settled_audit()
    flush_http()
    expect(st_t == 408 and TIMEOUT_S <= cut_s < TIMEOUT_S + 2.0,
           f"timeout: status {st_t} after {cut_s:.2f} s")
    # cut: some frames came, then the connection ended without [DONE]
    expect(cut_frames and "[DONE]" not in cut_frames,
           f"timed-out stream: {len(cut_frames)} frames, error {cut_err}")
    # the cancel aborts the request in the engine; the engine's own copy of
    # the budget may end it first (finish "timeout"): either, once each
    expect(sum(ended) == 2, f"timeouts ended {ended} (aborts, deadlines) in the engine")
    expect(audit["clean"] and engine.scheduler.pool.free_count == free0,
           f"after the timeouts: audit {audit}, free {engine.scheduler.pool.free_count}")
    # 6. tool call, reasoning and harmony through the engine
    parse = {}
    for name, port, extra in (("tool", ports["parse"], {"tools": [WEATHER_TOOL]}),
                              ("think", ports["parse"], {}),
                              ("harmony", ports["harmony"], {})):
        words, script = scripts[name]
        script_tok.script = script
        body = {"model": SERVE_MODEL, "messages": [{"role": "user", "content": words}],
                "max_tokens": len(script), "temperature": 0, "ignore_eos": True, **extra}
        flush_http()
        st, r = _http(port, "POST", chat, body)
        flush_http()
        st_s, frames = _sse(port, chat, {**body, "stream": True})
        script_tok.script = {}
        msg = r["choices"][0]["message"] if st == 200 else {}
        deltas = [f["choices"][0] for _t, f in frames if f != "[DONE]" and f["choices"]]
        s_content = "".join(d["delta"].get("content") or "" for d in deltas)
        s_reason = "".join(d["delta"].get("reasoning_content") or "" for d in deltas)
        s_finish = next((d["finish_reason"] for d in deltas if d.get("finish_reason")), None)
        s_calls = [c for d in deltas for c in d["delta"].get("tool_calls") or []]
        parse[name] = dict(status=(st, st_s), message=msg, stream_content=s_content,
                           stream_reasoning=s_reason, stream_finish=s_finish)
        if name == "tool":
            calls = msg.get("tool_calls") or []
            args = "".join(c["function"].get("arguments") or "" for c in s_calls)
            names = [c["function"]["name"] for c in s_calls if c["function"].get("name")]
            ok = (st == st_s == 200 and r["choices"][0]["finish_reason"] == "tool_calls"
                  and len(calls) == 1 and calls[0]["function"]["name"] == "get_weather"
                  and json.loads(calls[0]["function"]["arguments"])
                  == {"city": "Paris", "unit": "c"}
                  and s_finish == "tool_calls" and names == ["get_weather"]
                  and args == calls[0]["function"]["arguments"])
            expect(ok, f"tool call: {r} / streamed {s_calls} {s_finish}")
        elif name == "think":
            ok = (st == st_s == 200 and msg.get("reasoning_content") == "weigh the options"
                  and msg.get("content") == "The answer is 4."
                  and s_reason == "weigh the options" and s_content == "The answer is 4.")
            expect(ok, f"reasoning: {msg} / streamed {s_reason!r} {s_content!r}")
        else:
            ok = (st == st_s == 200 and msg.get("reasoning_content") == "thinking hard"
                  and msg.get("content") == "It is sunny."
                  and s_reason == "thinking hard" and s_content == "It is sunny.")
            expect(ok, f"harmony: {msg} / streamed {s_reason!r} {s_content!r}")
    # 7. the eight concurrent streams through the bare and the full gateway
    # in turns, sent from a client process of their own (threads here would
    # wait for this process's interpreter lock at every send and read); the
    # full one's SLO records against the client's frames
    conc = {"bare": [], "full": []}
    sent_ns = {}
    for turn, name in enumerate(("bare", "full", "full", "bare")):
        flush_http()
        hdrs = [dict(auth, **{"X-Request-Id": f"conc-{label}-{turn}-{i}"}) if name == "full"
                else None for i in range(len(jobs["conc"]))]
        streams = _sse_from_a_client_process(
            ports[name], [_chat(p, 32, stream=True) for p in jobs["conc"]], hdrs)
        per_token, client = [], {}
        for i, (sent, st, frames) in enumerate(streams):
            sent_ns[f"conc-{label}-{turn}-{i}"] = sent
            text, finish, _u = _sse_text(frames)
            expect(st == 200 and frames[-1][1] == "[DONE]" and finish == "length",
                   f"{name} stream {i}: {st} {finish}")
            body = [(t, f) for t, f in frames if f != "[DONE]" and f["choices"]]
            for (a, _fa), (b, fb) in zip(body, body[1:]):
                n = len((fb["choices"][0]["delta"].get("content") or "").split()) or 1
                per_token.append((b - a) * 1e3 / n)
            client[f"conc-{label}-{turn}-{i}"] = _client_slo(frames)
        conc[name].append(dict(token_gap_ms=statistics.median(per_token), client=client))
    # the front door of each of the full gateway's streams: the request
    # span's start against the client's send (wall clocks of one host), and
    # dispatch (the prefill span's start) against the request span; the
    # prefill span ends where the router takes the first chunk
    tracer = ctxs["full"].tracer
    asyncio.run_coroutine_threadsafe(tracer.flush(), loop).result(60)
    by_rid: dict = {}
    prefill_end: dict = {}
    for sp in collector.spans:
        attrs = {a["key"]: next(iter(a["value"].values())) for a in sp["attributes"]}
        rid = attrs.get("request.id") or attrs.get("rid")
        if rid in sent_ns:
            by_rid.setdefault(rid, {})[sp["name"]] = int(sp["startTimeUnixNano"])
            if sp["name"] == "engine.prefill":
                prefill_end[rid] = int(sp["endTimeUnixNano"])
    front = {r: ((d[f"POST {chat}"] - sent_ns[r]) / 1e6,
                 (d["engine.prefill"] - d[f"POST {chat}"]) / 1e6)
             for r, d in by_rid.items() if f"POST {chat}" in d and "engine.prefill" in d}
    front_ms = ({"send_to_request_span": statistics.median(a for a, _b in front.values()),
                 "request_span_to_dispatch": statistics.median(b for _a, b in front.values()),
                 "max_send_to_dispatch": max(a + b for a, b in front.values())}
                if front else {})
    st, slo = _http(full, "GET", "/debug/slo?recent=256", headers=auth)
    records = {r["rid"]: r for r in slo["recent"]} if st == 200 else {}

    def p50s(run):
        # the SLO's TTFT runs from the first dispatch, as the reference's
        # does; the client's from its send.  The client's TTFT from dispatch
        # takes each request's own front door off its first frame's time
        rids = sorted(run["client"])
        srv = [records.get(r) for r in rids]
        if any(r is None for r in srv) or any(r not in front for r in rids):
            return None
        return dict(client_ttft_ms=_pct([run["client"][r][0] for r in rids], 50) * 1e3,
                    client_ttft_from_dispatch_ms=_pct(
                        [run["client"][r][0] - sum(front[r]) / 1e3 for r in rids], 50) * 1e3,
                    slo_ttft_ms=_pct([r["ttft_s"] for r in srv], 50) * 1e3,
                    client_itl_ms=_pct([run["client"][r][1] for r in rids], 50) * 1e3,
                    slo_itl_ms=_pct([r["itl_mean_s"] for r in srv], 50) * 1e3,
                    # not held to anything: the router's first chunk to the
                    # client's first frame, which neither TTFT above sees
                    back_door_ms=_pct([(sent_ns[r] + run["client"][r][0] * 1e9
                                        - prefill_end[r]) / 1e6
                                       for r in rids if r in prefill_end], 50))

    slo_check = [p50s(run) for run in conc["full"]]
    for c in slo_check:
        expect(c is not None and all(
            abs(c[f"slo_{m}_ms"] - c[f"client_{k}_ms"]) <= SLO_TOLERANCE * c[f"client_{k}_ms"]
            for m, k in (("ttft", "ttft_from_dispatch"), ("itl", "itl"))),
            f"/debug/slo p50s against the client's: {c}")
    st, verdicts = _http(full, "GET", "/debug/slo/verdicts", headers=auth)
    v = {x["slo"]: x["verdict"] for x in verdicts.get("verdicts", [])} if st == 200 else {}
    measured_p50 = min((c["slo_ttft_ms"] for c in slo_check if c), default=0.0) / 1e3
    expect(v == {"lenient": "pass", "strict": "fail"} and measured_p50 > 1e-6,
           f"SLO verdicts {v}")
    # 8. one chat with a traceparent: the root span and its engine.* stage
    # spans reach the collector, in that trace, under the right parents
    upstream_trace, upstream_span = "ab" * 16, "cd" * 8
    st, _r = _http(full, "POST", chat, _chat(jobs["ok"][0], 8),
                   dict(auth, traceparent=f"00-{upstream_trace}-{upstream_span}-01"))
    stages = {"engine.queue", "engine.tokenize", "engine.prefill", "engine.decode",
              "engine.detokenize"}

    def traced():
        return [s for s in collector.spans if s["traceId"] == upstream_trace]

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and len(traced()) < 1 + len(stages):
        asyncio.run_coroutine_threadsafe(tracer.flush(), loop).result(30)
        time.sleep(0.05)
    spans = traced()
    roots = [s for s in spans if s["name"] == f"POST {chat}"]
    root = roots[0] if len(roots) == 1 else {}
    children = {s["name"]: s for s in spans if s is not root}
    expect(st == 200 and root.get("parentSpanId") == upstream_span
           and set(children) == stages
           and all(c.get("parentSpanId") == root.get("spanId") for c in children.values()),
           f"span tree: {[(s['name'], s.get('parentSpanId')) for s in spans]}")
    http_s = time.perf_counter() - t_http
    # 9. launches through the HTTP path: exact
    torch.cuda.synchronize()
    launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
    stats = dict(engine.runner.stats)
    want = {"decode_attention": L * stats["decode_columns"],
            "prefill_attention": L * stats["prefill_calls"]}
    expect(launches == want and min(launches.values()) > 0,
           f"launches {launches} != {want}")
    direct_per_token = statistics.median(
        g * 1e3 / max(n, 1) for r in together.values() for g, n in r[4])
    full_gap = statistics.median(c["token_gap_ms"] for c in conc["full"])
    bare_gap = statistics.median(c["token_gap_ms"] for c in conc["bare"])
    out = dict(
        launches=launches, schedule=stats, http_s=http_s, agreement=agree,
        lone_ttft_ms={k: statistics.median(v) for k, v in lone.items()},
        lone_ttft_samples_ms=lone,
        added_ttft_ms=statistics.median(lone["full"]) - statistics.median(lone["bare"]),
        preemption_latency_ms=preempt_ms, timeout_cut_s=cut_s, timeout_ended=ended,
        token_gap_ms={"full": full_gap, "bare": bare_gap, "direct": direct_per_token,
                      "runs": {k: [c["token_gap_ms"] for c in v] for k, v in conc.items()}},
        gateway_ms_per_token={"full": full_gap - direct_per_token,
                              "bare": bare_gap - direct_per_token,
                              "phase5_bare": bare.get("gateway_ms_per_token")},
        slo=slo_check, front_door_ms=front_ms, verdicts=v,
        parse={k: d["status"] for k, d in parse.items()},
        spans=len(spans))
    print(f"  [{card}] {label} policy layer: gateway cost per token with every layer on "
          f"{out['gateway_ms_per_token']['full']:.3f} ms, bare "
          f"{out['gateway_ms_per_token']['bare']:.3f} ms (phase 5 "
          f"{bare.get('gateway_ms_per_token', float('nan')):.3f}); per-token gap full "
          f"{full_gap:.3f} / bare {bare_gap:.3f} / direct {direct_per_token:.3f} ms")
    print(f"  [{card}] {label} lone chat TTFT full {out['lone_ttft_ms']['full']:.2f} ms, bare "
          f"{out['lone_ttft_ms']['bare']:.2f} ms (added {out['added_ttft_ms']:.2f} ms); "
          f"preemption latency {preempt_ms:.2f} ms; timeout 408 after {cut_s:.3f} s, engine "
          f"endings (aborts, deadlines) {ended}")
    print(f"  [{card}] {label} /debug/slo vs client p50s: {slo_check}; front door of the "
          f"eight streams (median ms) {front_ms}; verdicts {v}; "
          f"agreement {agree}; {len(spans)} spans; launches {launches} (expected {want})")
    if failures:
        raise AssertionError(f"[{label}] policy checks failed: {failures}")
    return out


def _sse_burst(port: int, bodies: list, headers: list) -> list:
    """The streamed chats ``bodies`` sent at once, one thread each, as a
    client with a connection pool sends them: every connection is open and
    every request built before a barrier, and each thread's clock starts
    at its send.  [(wall-clock ns at the send, status, [(seconds since the
    send, payload)])] in order."""
    import http.client
    import threading

    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=LOOP_WAIT_S)
             for _ in bodies]
    for c in conns:
        c.connect()
    payloads = [json.dumps(b).encode() for b in bodies]
    ready = threading.Barrier(len(bodies))

    def one(conn, payload, hdr):
        hdrs = {"Content-Type": "application/json", **(hdr or {})}
        ready.wait()
        sent, t0 = time.time_ns(), time.perf_counter()
        conn.request("POST", "/v1/chat/completions", body=payload, headers=hdrs)
        resp = conn.getresponse()
        frames = []
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                data = line[len("data: "):]
                frames.append((time.perf_counter() - t0,
                               data if data == "[DONE]" else json.loads(data)))
        conn.close()
        return sent, resp.status, frames

    return _in_threads(one, list(zip(conns, payloads, headers)))


def _sse_from_a_client_process(port: int, bodies: list, headers: list) -> list:
    """``_sse_burst`` run in a new Python process, so the client's threads
    never wait for this process's interpreter lock."""
    src = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as c; "
           "a = json.loads(sys.argv[2]); "
           "print(json.dumps(c._sse_burst(a['port'], a['bodies'], a['headers'])))")
    args = json.dumps({"port": port, "bodies": bodies, "headers": headers})
    done = subprocess.run([sys.executable, "-c", src, str(REPO), args], capture_output=True,
                          text=True, timeout=LOOP_WAIT_S)
    if done.returncode != 0:
        raise AssertionError(f"the client process failed: {done.stderr[-2000:]}")
    return [(sent, st, [(t, f) for t, f in frames])
            for sent, st, frames in json.loads(done.stdout)]


def _sse_cut(port: int, body: dict) -> tuple[list, str | None]:
    """A streamed request the server may cut: (payloads read, the error that
    ended the read, or None after a clean end)."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", method="POST",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    frames = []
    try:
        with urllib.request.urlopen(req, timeout=LOOP_WAIT_S) as resp:
            for line in resp:
                line = line.decode().strip()
                if line.startswith("data: "):
                    frames.append(line[len("data: "):])
    except Exception as e:  # the cut: IncompleteRead or a reset
        return frames, f"{type(e).__name__}: {e}"
    return frames, None


# ---- phase 7: speculative decoding on Llama-3-8B ----

SPEC_NEW = 32  # new tokens of every phase-7 request


def _spec_jobs(seed: int):
    """Phase 7's four requests and a warm-up prompt: ``rep``, greedy on a
    50-token block repeated 20 times; ``plain``, greedy on 200 random
    tokens; ``hot``, temperature 0.8 and top-k 50 on a 40-token block
    repeated 25 times; ``stop``, a stop-string lane that never stops (it
    must stay on the K=1 rest megastep)."""
    import numpy as np

    from smg_tpu_torch.protocols.sampling import SamplingParams as SP

    rng = np.random.default_rng(seed)
    tok = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    greedy = dict(temperature=0.0, max_new_tokens=SPEC_NEW, ignore_eos=True)
    jobs = [("rep", tok(50) * 20, SP(**greedy)),
            ("plain", tok(200), SP(**greedy)),
            ("hot", tok(40) * 25, SP(temperature=0.8, top_k=50, max_new_tokens=SPEC_NEW,
                                     ignore_eos=True)),
            ("stop", tok(120), SP(**greedy, stop=[NEVER_STOP]))]
    return jobs, tok(50) * 18


# (label, speculative, decode_graphs, overlap_schedule, loop thread) of the
# n-gram tier: the serving path, the same with overlap off, the eager
# synchronous path, and the serving path without speculation
SPEC_PATHS = (
    ("graphs", True, True, True, True),
    ("graphs_sync", True, True, False, False),
    ("eager", True, False, False, False),
    ("nospec", False, True, True, True),
)


def spec_drive(engine, jobs, loop: bool) -> tuple[dict, float, dict]:
    """Submit every job before the first step (a schedule that does not
    depend on timing), then step to the end on the loop thread or this
    one.  Returns (results, wall s, rid -> [verify blocks, drafted,
    accepted])."""
    from smg_tpu_torch.engine.engine import collect_result

    sched = engine.scheduler
    consume = sched._consume_spec_frame
    lanes = {rid: [0, 0, 0] for rid, _, _ in jobs}

    def tallied(frame, outputs):
        fetch_s = consume(frame, outputs)
        for idx, (_slot, req, _e) in enumerate(frame.lanes):
            drafted = frame.draft_ns[idx]
            tally = lanes[req.rid]
            tally[0] += 1
            tally[1] += drafted
            tally[2] += max(0, min(int(frame.launch.n_emit[idx]) - 1, drafted))
        return fetch_s

    sched._consume_spec_frame = tallied
    chunks = {rid: [] for rid, _, _ in jobs}
    for rid, prompt, sp in jobs:
        engine.submit(prompt, sp, rid=rid, on_output=chunks[rid].append)
    t0 = time.perf_counter()
    if loop:
        engine.start()
        wait_for(lambda: all(c and c[-1].finished for c in chunks.values())
                 and not engine.has_work(), "the speculative requests")
        engine.stop()
    else:
        for _ in range(2000):
            if not engine.has_work():
                break
            engine.step()
        else:
            raise RuntimeError("requests did not finish within 2000 steps")
    wall_s = time.perf_counter() - t0
    del sched._consume_spec_frame
    return {rid: collect_result(rid, c) for rid, c in chunks.items()}, wall_s, lanes


def spec_run(cfg, params, dev, tok, jobs, warm, speculative: bool, graphs: bool,
             overlap: bool, loop: bool, draft=None, draft_params=None) -> dict:
    """One engine with phase 3's settings (plus ``speculative`` and, for the
    draft tier, ``draft`` = (draft ModelConfig, seed)): a warm-up request on
    a prompt of the repeated request's shape, then the jobs, with the
    kernel counters, the runner's schedule counts and the drafted and
    accepted counts zeroed just before them and read just after."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    econf = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4, overlap_schedule=overlap,
                                  speculative=speculative),
        decode_graphs=graphs,
        draft_model=None if draft is None else draft[0],
        draft_seed=0 if draft is None else draft[1])
    engine = Engine(econf, params=params, device=dev, tokenizer=tok,
                    draft_params=draft_params)
    engine.generate(warm, SamplingParams(temperature=0.0, max_new_tokens=24,
                                         ignore_eos=True))
    sched, runner = engine.scheduler, engine.runner
    for stats in (runner.stats, *(() if sched.draft is None else (sched.draft.stats,))):
        for k in stats:
            stats[k] = 0
    sched.num_spec_drafted = sched.num_spec_accepted = 0
    torch.cuda.synchronize()
    dk.launches = pk.launches = 0
    results, wall_s, lanes = spec_drive(engine, jobs, loop)
    torch.cuda.synchronize()
    out = dict(results=results, wall_s=wall_s, lanes=lanes,
               launches={"decode_attention": dk.launches, "prefill_attention": pk.launches},
               stats=dict(runner.stats), draft_stats=None if sched.draft is None
               else dict(sched.draft.stats),
               drafted=sched.num_spec_drafted, accepted=sched.num_spec_accepted,
               loads=engine.loads())
    if runner.graphs.stats()["verify_graphs"]:
        out["timing"] = _verify_timing(runner)
    del engine, sched, runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _verify_timing(runner) -> dict:
    """Device ms of the widest verify graph the run captured (W = 9, the
    batch bucket and page-table width of the run) against one decode
    column of a megastep graph at the same (B, mp): each replayed alone
    with a cold L2 (``cuda_ms``).  Replays rewrite KV in the run's pages;
    the engine is dropped right after."""
    ver = max((s for s in runner.graphs.verify.values() if s.graph is not None),
              key=lambda s: (s.W, s.mp))
    megas = [s for s in runner.graphs.steps.values() if s.graph is not None
             and (s.B, s.mp) == (ver.B, ver.mp)]
    out = dict(verify_shape=dict(B=ver.B, mp=ver.mp, W=ver.W),
               verify_ms=cuda_ms(ver.graph.replay))
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ver.graph.replay()
        torch.cuda.synchronize()
    busy, by_kernel, _n = device_time(prof)
    out["verify_profile_ms"] = busy / 3
    out["verify_top"] = [(name[:70], ms / 3) for name, ms in
                         sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]]
    if megas:
        mega = max(megas, key=lambda s: s.K)
        out.update(decode_shape=dict(B=mega.B, mp=mega.mp, K=mega.K),
                   decode_ms_per_column=cuda_ms(mega.graph.replay) / mega.K)
        out["verify_over_column"] = out["verify_ms"] / out["decode_ms_per_column"]
    return out


def check_spec_launches(r, L: int, L_draft: int, label: str) -> None:
    """The run's kernel launches equal its schedule: L per rest-lane decode
    column (graph replays included), L per target prefill call and L_draft
    per draft prefill call; the verify block and the draft's compat decode
    launch neither kernel."""
    st, ds = r["stats"], r["draft_stats"] or {"prefill_calls": 0}
    expect = {"decode_attention": L * st["decode_columns"],
              "prefill_attention": L * st["prefill_calls"] + L_draft * ds["prefill_calls"]}
    print(f"  [{label}] schedule: {st}, draft {r['draft_stats']}; launches {r['launches']}, "
          f"expected {expect}")
    if r["launches"] != expect or r["launches"]["prefill_attention"] <= 0:
        raise AssertionError(f"[{label}] launch counts {r['launches']} != {expect}")


def check_serve_speculative(device: str, flags: tuple, model: str,
                            prompt: str = "w5 w6 w7 w8 " * 8) -> dict:
    """``python -m smg_tpu_torch.cli serve --speculative`` in a process of
    its own on the card, in float32, with ``flags`` naming the target and
    the draft (phase 8: ``--model-path`` and ``--draft-model-path``): one greedy
    24-token completion of ``prompt``, the engine's drafted tokens from
    ``/scheduler``, then SIGTERM.  Every process started here is stopped
    before it returns."""
    import signal
    import tempfile

    port = _free_port()
    cmd = [sys.executable, "-m", "smg_tpu_torch.cli", "serve", *flags,
           "--dtype", "float32", "--speculative", "--max-batch-size", "8",
           "--max-seq-len", "1024", "--host", "127.0.0.1", "--port", str(port),
           "--device", device]
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=log)
        try:
            deadline = time.monotonic() + LOOP_WAIT_S
            while True:
                try:
                    if _http(port, "GET", "/health")[0] == 200:
                        break
                except OSError:
                    pass
                if proc.poll() is not None or time.monotonic() > deadline:
                    log.seek(0)
                    raise AssertionError("serve --speculative did not come up: "
                                         + log.read().decode()[-2000:])
                time.sleep(0.2)
            status, body = _http(port, "POST", "/v1/completions", {
                "model": model, "prompt": prompt, "max_tokens": 24, "temperature": 0,
                "ignore_eos": True})
            loads = _http(port, "GET", "/scheduler")[1]["engine"]
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
    worker = next(iter(loads.values()))
    out = dict(status=status, completion_tokens=body["usage"]["completion_tokens"]
               if status == 200 else None, drafted=worker.get("spec_drafted"),
               accepted=worker.get("spec_accepted"), exit_code=proc.returncode)
    print(f"  serve --speculative {' '.join(flags)}: {out}")
    if not (status == 200 and out["completion_tokens"] == 24 and out["drafted"]):
        raise AssertionError(f"serve --speculative: {out}")
    return out


def phase_spec(cfg, params, dev, card: str, label: str, strict: bool) -> dict:
    """Speculative decoding on Llama-3-8B at full width and depth, phase 3's
    engine settings plus ``speculative=True`` (8 drafts, a 9-wide verify
    block).  The n-gram tier through ``SPEC_PATHS``, then the draft tier
    on the serving path: a ``DraftRunner`` over the target's own weights
    (``draft_params``), so drafts are the target's greedy picks, and
    Llama-3.2-1B at random bf16 weights from ``draft_seed``, with overlap
    on and off.  Every lane but the stop lane must draft in the draft
    tiers.  With ``strict`` (float32) every greedy stream must equal the
    non-speculative run's, the graph and eager streams must be identical,
    the self-draft tier must accept at least 90% of its greedy drafts; in
    both dtypes the sampled stream must be identical with overlap on and
    off (n-gram and 1B tiers), the stop-string lane must never ride a
    verify block, launches must match the schedule and every audit must
    be clean."""
    import dataclasses

    from smg_tpu_torch.models.config import llama32_1b_config

    tok = PieceTokenizer(cfg.vocab_size, (cfg.bos_token_id, *cfg.eos_token_ids))
    L = cfg.num_layers
    jobs, warm = _spec_jobs(23)
    runs = {}
    for name, spec, graphs, overlap, loop in SPEC_PATHS:
        runs[name] = spec_run(cfg, params, dev, tok, jobs, warm, spec, graphs, overlap, loop)
    draft_1b = dataclasses.replace(llama32_1b_config(), dtype="bfloat16")
    runs["self_draft"] = spec_run(cfg, params, dev, tok, jobs, warm, True, True, True, True,
                                  draft=(cfg, 0), draft_params=params)
    for name, overlap in (("draft_1b", True), ("draft_1b_sync", False)):
        runs[name] = spec_run(cfg, params, dev, tok, jobs, warm, True, True, overlap, overlap,
                              draft=(draft_1b, 1))
    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [{label}] FAILED: {what}")

    base = runs["nospec"]["results"]
    out: dict = {"card": card}
    for name, r in runs.items():
        L_draft = L if name == "self_draft" else (
            draft_1b.num_layers if name.startswith("draft_1b") else 0)
        check_spec_launches(r, L, L_draft, f"{label}/{name}")
        audit = r["loads"]["audit"]
        expect(audit["clean"] and audit["leaked_pages"] == 0, f"{name}: audit {audit}")
        for rid, res in r["results"].items():
            expect(res.output_tokens == SPEC_NEW and res.finish_reason == "length",
                   f"{name}/{rid}: {res.output_tokens} tokens, finish {res.finish_reason}")
        expect(r["lanes"]["stop"][0] == 0, f"{name}: the stop-string lane rode a verify block")
        if L_draft:  # a draft model always proposes
            expect(all(r["lanes"][rid][1] > 0 for rid in ("rep", "plain", "hot")),
                   f"{name}: a lane drafted nothing: {r['lanes']}")
        emitted = sum(res.output_tokens for res in r["results"].values())
        same = {rid: res.token_ids == base[rid].token_ids for rid, res in r["results"].items()
                if rid != "hot"}
        row = dict(wall_s=r["wall_s"], ms_per_token=r["wall_s"] * 1e3 / emitted,
                   tok_s=emitted / r["wall_s"], drafted=r["drafted"], accepted=r["accepted"],
                   acceptance=r["accepted"] / r["drafted"] if r["drafted"] else None,
                   lanes=r["lanes"], verify_calls=r["stats"]["verify_calls"],
                   decode_columns=r["stats"]["decode_columns"],
                   greedy_equal_nospec=same, launches=r["launches"],
                   verify_graphs=r["loads"]["verify_graphs"],
                   verify_capture_s=r["loads"]["verify_capture_s"],
                   verify_capture_bytes=r["loads"]["verify_capture_bytes"])
        if "timing" in r:
            row.update(r["timing"], name=name)
        out[name] = row
        if strict:
            expect(all(same.values()), f"{name}: greedy streams differ from the "
                                       f"non-speculative run: {same}")
    for on, off in (("graphs", "graphs_sync"), ("draft_1b", "draft_1b_sync")):
        expect(runs[on]["results"]["hot"].token_ids == runs[off]["results"]["hot"].token_ids,
               f"the temperature-0.8 stream differs with overlap on and off ({on}, {off})")
    out["hot_graphs_vs_eager_equal"] = (runs["graphs"]["results"]["hot"].token_ids
                                        == runs["eager"]["results"]["hot"].token_ids)
    if strict:
        for rid in base:
            if rid != "hot":
                expect(runs["graphs"]["results"][rid].token_ids
                       == runs["eager"]["results"][rid].token_ids,
                       f"{rid}: graph and eager streams differ")
        sd = [runs["self_draft"]["lanes"][rid] for rid in ("rep", "plain")]
        drafted, accepted = sum(t[1] for t in sd), sum(t[2] for t in sd)
        expect(accepted >= 0.9 * drafted,
               f"self-draft tier accepted {accepted} of {drafted} greedy drafts")
    nospec_ms = out["nospec"]["ms_per_token"]
    for name in ("graphs", "self_draft", "draft_1b"):
        row = out[name]
        row["speedup_vs_nospec"] = nospec_ms / row["ms_per_token"]
        print(f"  [{card}] {label} spec {name}: {row['ms_per_token']:.3f} ms/token, "
              f"{row['tok_s']:.2f} tok/s (non-spec {nospec_ms:.3f} ms/token, "
              f"{out['nospec']['tok_s']:.2f} tok/s; x{row['speedup_vs_nospec']:.3f}), "
              f"acceptance {row['accepted']}/{row['drafted']}"
              f" = {row['acceptance'] if row['acceptance'] is None else round(row['acceptance'], 4)}"
              f", verify blocks {row['verify_calls']}, rest columns {row['decode_columns']}"
              f"; per lane [blocks, drafted, accepted] {row['lanes']}")
    # the n-gram tier may draft nothing on random weights (no graph then)
    t = next((out[n] for n in ("graphs", "self_draft", "draft_1b") if "verify_ms" in out[n]),
             {})
    if t:
        print(f"  [{label}] verify timing from the {t['name']} run")
        print(f"  [{card}] {label} verify block {t['verify_shape']}: {t['verify_ms']:.3f} ms "
              "device" + (f", one decode column {t['decode_shape']}: "
                          f"{t['decode_ms_per_column']:.3f} ms (x{t['verify_over_column']:.3f})"
                          if "decode_ms_per_column" in t else "")
              + f"; verify graphs {t['verify_graphs']}, capture {t['verify_capture_s']:.3f} s, "
                f"{t['verify_capture_bytes']} bytes; profiled {t['verify_profile_ms']:.3f} ms "
                "a block, by kernel:")
        for kname, ms in t["verify_top"]:
            print(f"    {ms:8.3f} ms/block  {kname}")
    for name, row in out.items():
        if isinstance(row, dict) and "greedy_equal_nospec" in row:
            print(f"  [{label}] {name}: greedy streams equal to non-spec "
                  f"{row['greedy_equal_nospec']}")
    if failures:
        raise AssertionError(f"[{label}] speculation checks failed: {failures}")
    return out


# ---- phase 8: an HF checkpoint directory, its tokenizer, LoRA adapters ----

CKPT_SHARDS = 4  # safetensors files of the written checkpoint, with an index
CKPT_MODEL = "llama3-8b-hf"  # the directory's name: the served model id ends in it
LORA_RANK, LORA_ALPHA = 16, 32  # the PEFT adapters (q/k/v/o), alpha/r = 2
LORA_NEW = 32  # new tokens of every phase-8 lane
# an adapter lane's first-token logits against an engine whose weights have
# the adapter merged in: float32 differs in summation order only (held as
# the kernel-vs-plain logits are); in bf16 the merged weights are rounded
# once more, so the lane is held to be nearer the merged engine than the
# base model is, by at least this factor
MERGED_F32_ATOL = 2e-3
MERGED_BF16_RATIO = 0.5
LLAMA3_TEMPLATE = (
    "{{- bos_token }}{%- for message in messages %}{{- '<|start_header_id|>' + "
    "message['role'] + '<|end_header_id|>\\n\\n' + message['content'] | trim + "
    "'<|eot_id|>' }}{%- endfor %}{%- if add_generation_prompt %}{{- "
    "'<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{%- endif %}")


def llama3_special_tokens() -> list:
    """Llama-3's names of ids 128000-128255, in order."""
    named = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 4: "<|finetune_right_pad_id|>",
             6: "<|start_header_id|>", 7: "<|end_header_id|>", 8: "<|eom_id|>",
             9: "<|eot_id|>", 10: "<|python_tag|>"}
    out, reserved = [], 0
    for i in range(256):
        if i in named:
            out.append(named[i])
        else:
            out.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return out


def write_tokenizer(path: Path, vocab_size: int) -> None:
    """A ``tokenizer.json`` built with ``tokenizers``: a word-level model
    whose ids below ``vocab_size - 256`` are ``w<id>`` (the last four are
    ``<unk>``, ``system``, ``user``, ``assistant``), split on whitespace,
    and Llama-3's special tokens at the top 256 ids; a
    ``tokenizer_config.json`` with a Llama-3-style chat template."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers

    n = vocab_size - 256
    vocab = {f"w{i}": i for i in range(n - 4)}
    vocab.update({w: n - 4 + j for j, w in enumerate(("<unk>", "system", "user",
                                                       "assistant"))})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in llama3_special_tokens()])
    if tok.get_vocab_size() != vocab_size or tok.token_to_id("<|begin_of_text|>") != n:
        raise AssertionError(f"tokenizer vocabulary {tok.get_vocab_size()} != {vocab_size}")
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
        "chat_template": LLAMA3_TEMPLATE}))


def hf_config(cfg) -> dict:
    """The ``config.json`` of an HF Llama checkpoint with ``cfg``'s fields
    (for Llama-3-8B: its published ones)."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "hidden_act": "silu", "rope_theta": cfg.rope_theta,
            "rope_scaling": cfg.rope_scaling, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_position_embeddings,
            "vocab_size": cfg.vocab_size, "bos_token_id": cfg.bos_token_id,
            "eos_token_id": list(cfg.eos_token_ids),
            "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": "bfloat16"}


# port layer key -> (HF module name, stored as an [out, in] linear)
HF_LAYER = {"attn_norm": ("input_layernorm", False), "wq": ("self_attn.q_proj", True),
            "wk": ("self_attn.k_proj", True), "wv": ("self_attn.v_proj", True),
            "wo": ("self_attn.o_proj", True), "mlp_norm": ("post_attention_layernorm", False),
            "w_gate": ("mlp.gate_proj", True), "w_up": ("mlp.up_proj", True),
            "w_down": ("mlp.down_proj", True)}


def write_checkpoint(cfg, params, path: Path, shards: int) -> dict:
    """``params`` (the port's layout, on the card) as an HF directory: the
    config, ``shards`` safetensors files of whole layers in HF names and
    layouts with ``model.safetensors.index.json``, the tokenizer.  One
    shard is on the host at a time."""
    from safetensors.torch import save_file

    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(hf_config(cfg)))
    L = cfg.num_layers
    per = math.ceil(L / shards)
    weight_map, nbytes = {}, 0
    t0 = time.perf_counter()
    for s in range(shards):
        part = {}
        if s == 0:
            part["model.embed_tokens.weight"] = params["embed"].cpu()
        for i in range(s * per, min(L, (s + 1) * per)):
            for key, (name, linear) in HF_LAYER.items():
                t = params["layers"][key][i]
                part[f"model.layers.{i}.{name}.weight"] = (
                    t.t() if linear else t).contiguous().cpu()
        if s == shards - 1:
            part["model.norm.weight"] = params["final_norm"].cpu()
            part["lm_head.weight"] = params["lm_head"].t().contiguous().cpu()
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        save_file(part, str(path / fname), metadata={"format": "pt"})
        nbytes += sum(t.numel() * t.element_size() for t in part.values())
        weight_map.update({k: fname for k in part})
        del part
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
    write_tokenizer(path, cfg.vocab_size)
    took = time.perf_counter() - t0
    files = sum(f.stat().st_size for f in path.glob("*.safetensors"))
    return dict(tensor_bytes=nbytes, file_bytes=files, write_s=took, files=shards)


def write_peft(cfg, path: Path, seed: int) -> None:
    """A PEFT adapter directory (rank ``LORA_RANK`` on q/k/v/o, bf16
    safetensors) from a seeded generator, scaled so it moves greedy
    streams of the random-weight model without swamping them."""
    import torch
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(seed)
    E, H, K, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dims = {"q_proj": (E, H * D), "k_proj": (E, K * D), "v_proj": (E, K * D),
            "o_proj": (H * D, E)}
    tensors = {}
    for layer in range(cfg.num_layers):
        for proj, (fin, fout) in dims.items():
            pre = f"base_model.model.model.layers.{layer}.self_attn.{proj}"
            tensors[f"{pre}.lora_A.weight"] = (
                torch.randn(LORA_RANK, fin, generator=gen) * 0.02).to(torch.bfloat16)
            tensors[f"{pre}.lora_B.weight"] = (
                torch.randn(fout, LORA_RANK, generator=gen) * 0.03).to(torch.bfloat16)
    path.mkdir(parents=True)
    save_file(tensors, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA", "r": LORA_RANK, "lora_alpha": LORA_ALPHA,
        "target_modules": list(dims)}))


def write_tiny_dir(path: Path, vocab_size: int) -> None:
    """A small Llama directory (2 layers, hidden 256) at the full
    vocabulary with the same tokenizer, float32 weights from a seed: the
    target and draft of ``serve --speculative --draft-model-path``."""
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import tiny_test_config
    from smg_tpu_torch.models.llama import init_params

    cfg = dataclasses.replace(tiny_test_config(vocab_size), hidden_size=256,
                              intermediate_size=512, num_layers=2, num_heads=4,
                              num_kv_heads=2, head_dim=64, bos_token_id=vocab_size - 256,
                              eos_token_ids=(vocab_size - 255, vocab_size - 247))
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    write_checkpoint(cfg, params, path, shards=1)


def _render_chat(messages) -> str:
    """The Llama-3 template rendered with jinja2 alone (the check on the
    gateway's own rendering)."""
    import jinja2

    env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
    return env.from_string(LLAMA3_TEMPLATE).render(
        messages=messages, add_generation_prompt=True, bos_token="<|begin_of_text|>")


def _ckpt_chats(seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    return {"short": [{"role": "user", "content": _words(ids(40))}],
            "long": [{"role": "system", "content": _words(ids(1300))},
                     {"role": "user", "content": _words(ids(90))}]}


def _lora_jobs(seed: int) -> list:
    """(rid, prompt ids, adapter): base, B, A, then a long A prompt.  The
    first three fit one prefill budget (a grouped prefill with mixed slots),
    the last is chunked; prompts are distinct, so no lane reuses another's
    KV through the prefix cache (which is not keyed by adapter)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    return [("base", ids(120), None), ("b", ids(150), "b"), ("a", ids(100), "a"),
            ("a_long", ids(1400), "a")]


def lora_drive(engine, jobs, loop: bool, max_new: int | None = None
               ) -> tuple[dict, dict, float]:
    """Submit every job at once (so every path schedules the same batches),
    then step on the engine's loop thread or this one.  Returns (rid ->
    result, rid -> first-token logits, wall seconds)."""
    from smg_tpu_torch.engine.engine import collect_result
    from smg_tpu_torch.protocols.sampling import SamplingParams

    model = engine.runner.model
    orig = model.forward_prefill_batched
    keys = {tuple(p[-8:]): rid for rid, p, _ in jobs}
    logits = {}

    def recording(tokens, prefix_lens, t_reals, *a, **kw):
        out = orig(tokens, prefix_lens, t_reals, *a, **kw)
        if out is not None:
            tk, tr = tokens.cpu(), t_reals.cpu()
            for i in range(tk.shape[0]):
                rid = keys.get(tuple(tk[i, : int(tr[i])][-8:].tolist()))
                if rid is not None:
                    logits[rid] = out[i].float().cpu()
        return out

    model.forward_prefill_batched = recording
    chunks: dict = {}
    t0 = time.perf_counter()
    try:
        for rid, prompt, name in jobs:
            chunks[rid] = []
            engine.submit(prompt, SamplingParams(temperature=0.0,
                                                 max_new_tokens=max_new or LORA_NEW,
                                                 ignore_eos=True, lora_adapter=name),
                          rid=rid, on_output=chunks[rid].append)
        done = lambda: all(c and c[-1].finished for c in chunks.values())  # noqa: E731
        if loop:
            engine.start()
            wait_for(lambda: done() and not engine.has_work(), "the LoRA lanes")
            engine.stop()
        else:
            steps = 0
            while engine.has_work():
                engine.step()
                steps += 1
                if steps > 500:
                    raise RuntimeError("engine did not finish within 500 steps")
    finally:
        model.forward_prefill_batched = orig
    wall = time.perf_counter() - t0
    return {rid: collect_result(rid, c) for rid, c in chunks.items()}, logits, wall


def merged_params(params: dict, weights: dict) -> dict:
    """``params`` with a canonical adapter merged into wq/wk/wv/wo (W +
    a @ b in float32, then the weights' dtype); every other tensor shared."""
    import torch

    layers = dict(params["layers"])
    for p in ("wq", "wk", "wv", "wo"):
        w = params["layers"][p]
        out = torch.empty_like(w)
        for i in range(w.shape[0]):
            a = torch.from_numpy(weights[f"{p}_a"][i]).to(w.device)
            b = torch.from_numpy(weights[f"{p}_b"][i]).to(w.device)
            out[i] = (w[i].float() + a @ b).to(w.dtype)
        layers[p] = out
    return {**params, "layers": layers}


def _lora_engine(cfg, params, dev, attention, graphs, overlap):
    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4, overlap_schedule=overlap),
        decode_graphs=graphs), params=params, device=dev, attention=attention)


def lora_paths(cfg, params, dev, adapters: dict, label: str, strict: bool,
               with_profile: bool) -> dict:
    """(c): the mixed batch (base, B, A, long A) through ``PATHS`` on
    ``params``, adapters loaded from their PEFT directories; a base-only run
    of the same prompts on the serving path; the LoRA lanes' first-token
    logits against engines with each adapter merged in; launch counts
    zeroed just before each measured drive and read just after, and every
    audit clean.  With ``with_profile``, decode of 4 LoRA lanes against 4
    base lanes on the serving path."""
    import gc

    import torch

    from smg_tpu_torch.models import lora as lora_mod
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    L = cfg.num_layers
    jobs = _lora_jobs(31)
    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [{label}] FAILED: {what}")

    runs, out = {}, {}
    for name, attention, graphs, overlap, loop in PATHS:
        engine = _lora_engine(cfg, params, dev, attention, graphs, overlap)
        slots = {n: engine.load_lora_adapter(n, path=str(p)) for n, p in adapters.items()}
        engine.generate(prompt_ids=list(range(1000, 1100)),  # warm-up, not counted
                        sampling=SamplingParams(temperature=0.0, max_new_tokens=4,
                                                lora_adapter="a"))
        engine.flush_cache()
        for k in engine.runner.stats:
            engine.runner.stats[k] = 0
        torch.cuda.synchronize()
        dk.launches = 0
        pk.launches = 0
        results, logits, wall = lora_drive(engine, jobs, loop)
        torch.cuda.synchronize()
        r = dict(results=results, logits=logits, wall_s=wall, stats=dict(engine.runner.stats),
                 launches={"decode_attention": dk.launches, "prefill_attention": pk.launches},
                 loads=engine.loads(), slots=slots)
        check_launches(r, L, f"{label}/lora/{name}", plain=name == "plain")
        audit = r["loads"]["audit"]
        expect(audit["clean"] and audit["leaked_pages"] == 0, f"{name}: audit {audit}")
        for rid, res in results.items():
            expect(res.output_tokens == LORA_NEW and res.finish_reason == "length",
                   f"{name}/{rid}: {res.output_tokens} tokens, finish {res.finish_reason}")
        expect(set(logits) == {rid for rid, _, _ in jobs}, f"{name}: first-token logits "
                                                           f"of {sorted(logits)}")
        if name == "graphs":
            out["bank_bytes"] = engine.runner._lora_bank.nbytes
            engine.flush_cache()
            base_jobs = [(rid, p, None) for rid, p, _ in jobs]
            base_res, base_logits, _ = lora_drive(engine, base_jobs, loop=True)
            r["base_only"] = base_res
            r["base_only_logits"] = base_logits
            if with_profile:
                engine.flush_cache()
                greedy = dict(temperature=0.0, max_new_tokens=128, ignore_eos=True)
                out["profile_lora"] = profile_decode(
                    engine, loop=True, label="decode profile, 4 LoRA lanes",
                    sampling=[SamplingParams(**greedy, lora_adapter="ab"[i % 2])
                              for i in range(4)])
                engine.flush_cache()
                out["profile_base"] = profile_decode(
                    engine, loop=True, label="decode profile, 4 base lanes",
                    sampling=[SamplingParams(**greedy)] * 4)
            out["decode_graphs"] = engine.loads()["decode_graphs"]
        runs[name] = r
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    g = runs["graphs"]
    lora_rids = [rid for rid, _, name in jobs if name]
    # the streams: identical across the paths in float32; the base lane
    # equal to the base-only run in both dtypes (slot 0 adds exact zeros)
    agree = {f"{a}_vs_{b}": sum(runs[a]["results"][rid].token_ids
                                == runs[b]["results"][rid].token_ids for rid, _, _ in jobs)
             for a, b in (("graphs", "eager"), ("eager", "plain"), ("graphs", "plain"))}
    out["streams_equal"] = agree
    if strict:
        expect(all(v == len(jobs) for v in agree.values()), f"streams differ: {agree}")
    expect(g["results"]["base"].token_ids == g["base_only"]["base"].token_ids,
           "the base lane differs from the base-only run")
    expect(torch.equal(g["logits"]["base"], g["base_only_logits"]["base"]),
           "the base lane's first-token logits differ from the base-only run's")
    moved = {rid: g["results"][rid].token_ids != g["base_only"][rid].token_ids
             for rid in lora_rids}
    out["adapter_moved_stream"] = moved
    expect(all(moved.values()), f"an adapter left its lane's stream unchanged: {moved}")
    out["launches"] = g["launches"]
    out["stats"] = g["stats"]
    # first-token logits against the merged weights
    gaps = {}
    for n, p in adapters.items():
        weights = lora_mod.load_peft_dir(str(p), cfg)
        engine = _lora_engine(cfg, merged_params(params, weights), dev, "kernel", False, False)
        mjobs = [(rid, prompt, None) for rid, prompt, name in jobs if name == n]
        _res, mlogits, _ = lora_drive(engine, mjobs, loop=False, max_new=1)
        for rid, _prompt, _n in mjobs:
            lane = g["logits"][rid]
            gaps[rid] = dict(lora_vs_merged=float((lane - mlogits[rid]).abs().max()),
                             base_vs_merged=float((g["base_only_logits"][rid]
                                                   - mlogits[rid]).abs().max()),
                             max_abs_logit=float(mlogits[rid].abs().max()))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["merged"] = gaps
    for rid, gp in gaps.items():
        if strict:
            expect(gp["lora_vs_merged"] <= MERGED_F32_ATOL,
                   f"{rid}: first-token logits {gp['lora_vs_merged']:.3e} from the merged "
                   f"engine's (limit {MERGED_F32_ATOL})")
        else:
            expect(gp["lora_vs_merged"] <= MERGED_BF16_RATIO * gp["base_vs_merged"],
                   f"{rid}: the LoRA lane ({gp['lora_vs_merged']:.3e}) is not nearer the "
                   f"merged engine than the base model ({gp['base_vs_merged']:.3e})")
    out["wall_s"] = {name: r["wall_s"] for name, r in runs.items()}
    print(f"  [{label}] LoRA lanes: streams equal across paths (of {len(jobs)}) {agree}; "
          f"adapter moved its stream {moved}; first-token logits against merged weights "
          + ", ".join(f"{rid} {gp['lora_vs_merged']:.3e} (base {gp['base_vs_merged']:.3e}, "
                      f"max |logit| {gp['max_abs_logit']:.2f})" for rid, gp in gaps.items())
          + f"; bank {out['bank_bytes']} bytes; launches {out['launches']}")
    if failures:
        raise AssertionError(f"[{label}] LoRA checks failed: {failures}")
    return out


def _tokenize_ms(registry, model_id: str, reps: int = 7) -> dict:
    """The gateway's tokenize (``TokenizerRegistry.encode_cached``) of a
    1400-token chat: an L1 miss (a new conversation), an L1 hit (the next
    turn of a conversation whose first turn was seen), and an L0 hit (the
    same text again); medians over ``reps`` distinct conversations."""
    import numpy as np

    rng = np.random.default_rng(41)
    miss, hit, l0 = [], [], []
    l1 = None
    for _ in range(reps):
        ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
        first = [{"role": "system", "content": _words(ids(1300))},
                 {"role": "user", "content": _words(ids(90))}]
        t1 = _render_chat(first)
        t0 = time.perf_counter()
        registry.encode_cached(model_id, t1)
        miss.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        registry.encode_cached(model_id, t1)
        l0.append((time.perf_counter() - t0) * 1e3)
        second = first + [{"role": "assistant", "content": _words(ids(10))},
                          {"role": "user", "content": _words(ids(8))}]
        t2 = _render_chat(second)
        l1 = registry._l1_for(registry.get(model_id))
        before = l1.stats()["hits"]
        t0 = time.perf_counter()
        registry.encode_cached(model_id, t2)
        hit.append((time.perf_counter() - t0) * 1e3)
        if l1.stats()["hits"] != before + 1:
            raise AssertionError("the next turn of a conversation missed the L1 cache")
    return dict(miss_ms=statistics.median(miss), l1_hit_ms=statistics.median(hit),
                l0_hit_ms=statistics.median(l0), l1=l1.stats(), tokens=len(
                    registry.encode_cached(model_id, _render_chat(first))))


def _serve_dir(path: Path, dtype: str, dev):
    """``serve --model-path`` built in process as the command line builds
    it (the loader timed), behind the gateway on a free local port;
    returns (engine, context, port, held, load seconds)."""
    import asyncio
    import threading

    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import (
        build_context,
        build_engine_from_args,
        gateway_options,
        serve_context,
    )
    from smg_tpu_torch.models import weights

    args = build_parser().parse_args([
        "serve", "--model-path", str(path), "--dtype", dtype, "--max-batch-size", "8",
        "--max-seq-len", "4096", "--max-prefill-tokens", "512", "--decode-horizon", "4",
        "--host", "127.0.0.1", "--port", str(_free_port()), "--device", str(dev)])
    timed = {}
    orig = weights.load_params

    def timed_load(*a, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        timed["load_s"] = time.perf_counter() - t0
        return out

    weights.load_params = timed_load
    try:
        engine = build_engine_from_args(args)
    finally:
        weights.load_params = orig
    ctx = build_context(engine, drain_timeout_secs=args.engine_drain_timeout_secs,
                        **gateway_options(args))
    held = {}

    async def serve():
        held["loop"], held["stop"] = asyncio.get_running_loop(), asyncio.Event()
        await serve_context(ctx, args.host, args.port, held["stop"])

    held["thread"] = threading.Thread(target=lambda: asyncio.run(serve()), name="gateway")
    held["thread"].start()
    wait_for(lambda: "stop" in held, "gateway start", timeout=60)
    deadline = time.monotonic() + 60
    while True:
        try:
            if _http(args.port, "GET", "/health")[0] == 200:
                break
        except OSError:
            if time.monotonic() > deadline:
                raise
        time.sleep(0.05)
    return engine, ctx, args.port, held, timed["load_s"]


def phase_checkpoint(cfg, params, dev, card: str, label: str, strict: bool,
                     ckpt: Path, adapters: dict, tiny: Path) -> dict:
    """Phase 8 on ``params`` (phase 3's weights in this dtype), the
    checkpoint ``ckpt`` written from their bf16 values: (a) ``serve
    --model-path`` (in ``cfg``'s dtype: float32 widens the bf16 files as
    they load) answers chats over HTTP with the HF tokenizer; (b) two PEFT
    adapters load through ``/load_lora_adapter`` and list; (d) unloading a
    busy adapter is refused, then succeeds and the slot is reused; the
    gateway's tokenize with an L1 hit and a miss; then (c) the LoRA lanes
    through every path (``lora_paths``) and, in float32, (e) ``serve
    --speculative --draft-model-path``."""
    import gc

    import torch
    from tokenizers import Tokenizer

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.tokenizer.hf import HFTokenizer

    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [{label}] FAILED: {what}")

    out: dict = {"card": card}
    expect(ModelConfig.from_pretrained(str(ckpt), dtype=cfg.dtype) == cfg,
           "from_pretrained differs from the preset's config")
    raw = Tokenizer.from_file(str(ckpt / "tokenizer.json"))
    chats = _ckpt_chats(37)
    want_ids = {k: raw.encode(_render_chat(m), add_special_tokens=False).ids
                for k, m in chats.items()}
    # the preset engine on the same weights: the streams HTTP must give
    tok = HFTokenizer(str(ckpt))
    preset = Engine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False,
                                     dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4)), params=params, device=dev, tokenizer=tok)
    preset.start()
    ref = {}
    for k, ids in want_ids.items():
        preset.flush_cache()
        ref.update(_direct(preset, [(k, ids, LORA_NEW)]))
    preset.stop()
    del preset
    gc.collect()
    torch.cuda.empty_cache()
    out.update(serve_checkpoint(cfg, params, dev, card, label, strict, ckpt, adapters,
                                chats, want_ids, ref, tok, expect))
    gc.collect()  # the served engine's weights and KV go before (c)'s engines come
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"[{label}] checkpoint checks failed: {failures}")
    print(f"  [{label}] (c) LoRA lanes through the serving path, eager and plain")
    out["lora"] = lora_paths(cfg, params, dev, adapters, label, strict,
                             with_profile=not strict)
    if not strict:
        p, b = out["lora"]["profile_lora"], out["lora"]["profile_base"]
        print(f"  [{card}] {label} decode, 4 LoRA lanes against 4 base lanes: device "
              f"{p['device_ms_per_column']:.3f} / {b['device_ms_per_column']:.3f} ms a column "
              f"(x{p['device_ms_per_column'] / b['device_ms_per_column']:.3f}), wall "
              f"{p['wall_ms_per_column']:.3f} / {b['wall_ms_per_column']:.3f} ms a column, "
              f"{4 / p['decode_tok_s'] * 1e3:.3f} / {4 / b['decode_tok_s'] * 1e3:.3f} ms a "
              f"token a lane; replay alone {p.get('replay_ms_per_column', float('nan')):.3f}"
              f" / {b.get('replay_ms_per_column', float('nan')):.3f} ms a column; bank "
              f"{out['lora']['bank_bytes']} bytes")
    if strict:
        out["serve_speculative_path"] = check_serve_speculative(
            device=dev.type, model=str(tiny),
            flags=("--model-path", str(tiny), "--draft-model-path", str(tiny)))
    return out


def serve_checkpoint(cfg, params, dev, card: str, label: str, strict: bool, ckpt: Path,
                     adapters: dict, chats: dict, want_ids: dict, ref: dict, tok,
                     expect) -> dict:
    """Phase 8's (a), (b), (d) and tokenize readings against ``serve
    --model-path ckpt``; every reference to the served engine ends with
    this call, so its memory can go before the next engines."""
    import torch

    out: dict = {}
    engine, ctx, port, held, load_s = _serve_dir(ckpt, cfg.dtype, dev)
    try:
        files = sum(f.stat().st_size for f in ckpt.glob("*.safetensors"))
        out["load"] = dict(seconds=load_s, file_bytes=files, gb_per_s=files / load_s / 1e9)
        print(f"  [{card}] {label} checkpoint load: {files} bytes in {load_s:.3f} s = "
              f"{files / load_s / 1e9:.3f} GB/s ({CKPT_SHARDS} files, page-cached)")
        loaded = engine.runner.model
        same = {k: torch.equal(getattr(loaded, k), params[k]) for k in params if k != "layers"}
        same.update({f"layers/{k}": torch.equal(getattr(loaded.layers, k), v)
                     for k, v in params["layers"].items()})
        del loaded
        out["weights_bitwise_equal"] = all(same.values())
        expect(all(same.values()), f"loaded tensors differ from phase 3's: "
                                   f"{[k for k, v in same.items() if not v]}")
        model_id = engine.config.model_id
        expect(model_id == str(ckpt), f"model id {model_id}")
        seen = []
        submit = engine.submit

        def recording_submit(prompt_ids, sampling, *a, **kw):
            seen.append(list(prompt_ids))
            return submit(prompt_ids, sampling, *a, **kw)

        engine.submit = recording_submit
        http = {}
        for k, msgs in chats.items():
            _http(port, "POST", "/flush_cache")
            st, body = _http(port, "POST", "/v1/chat/completions", {
                "model": model_id, "messages": msgs, "max_tokens": LORA_NEW,
                "temperature": 0, "ignore_eos": True})
            expect(st == 200, f"chat {k}: {st} {body}")
            http[k] = body["choices"][0]["message"]["content"] if st == 200 else None
        _http(port, "POST", "/flush_cache")
        st, frames = _sse(port, "/v1/chat/completions", {
            "model": model_id, "messages": chats["short"], "max_tokens": LORA_NEW,
            "temperature": 0, "ignore_eos": True, "stream": True})
        streamed = _sse_text(frames)[0]
        expect(st == 200 and frames[-1][1] == "[DONE]" and streamed == http["short"],
               "the streamed chat differs from the non-streamed one")
        del engine.submit, submit, recording_submit  # the class's method again
        ids_ok = {k: want_ids[k] in seen for k in chats}
        out["prompt_ids_equal_tokenizers"] = ids_ok
        expect(all(ids_ok.values()), f"gateway prompt ids differ from tokenizers': {ids_ok}")
        agree = {k: http[k] == tok.decode(ref[k][0]) for k in chats}
        out["http_equal_preset"] = agree
        print(f"  [{label}] serve --model-path: weights bitwise equal {all(same.values())}, "
              f"prompt ids equal tokenizers' {ids_ok}, chats equal the preset engine's "
              f"{agree} (prompts {[len(v) for v in want_ids.values()]} tokens)")
        if strict:
            expect(all(agree.values()), f"HTTP chats differ from the preset engine: {agree}")
        # (b) two adapters through the admin routes
        slots = {}
        for n, p in adapters.items():
            st, body = _http(port, "POST", "/load_lora_adapter",
                             {"lora_name": n, "lora_path": str(p)})
            expect(st == 200 and body["ok"], f"/load_lora_adapter {n}: {st} {body}")
            slots[n] = body["workers"][SERVE_WORKER].get("slot")
        st, listed = _http(port, "GET", "/list_lora_adapters")
        expect(st == 200 and listed["workers"][SERVE_WORKER] == sorted(adapters),
               f"/list_lora_adapters: {listed}")
        out["bank_bytes"] = engine.runner._lora_bank.nbytes
        _http(port, "POST", "/flush_cache")
        st, adapted = _http(port, "POST", "/v1/chat/completions", {
            "model": model_id, "messages": chats["short"], "max_tokens": LORA_NEW,
            "temperature": 0, "ignore_eos": True, "lora_adapter": "a"})
        expect(st == 200 and adapted["choices"][0]["message"]["content"] != http["short"],
               f"a chat with lora_adapter a: {st}, unchanged text")
        # (d) a busy adapter cannot be unloaded or replaced
        result = {}
        long_chat = threading_call(lambda: _http(port, "POST", "/v1/chat/completions", {
            "model": model_id, "messages": chats["short"], "max_tokens": 400,
            "temperature": 0, "ignore_eos": True, "lora_adapter": "a"}), result)
        wait_for(lambda: engine._lora_slot_busy(slots["a"]) or "value" in result,
                 "the adapter lane to start")
        busy_unload = _http(port, "POST", "/unload_lora_adapter", {"lora_name": "a"})
        busy_replace = _http(port, "POST", "/load_lora_adapter",
                             {"lora_name": "a", "lora_path": str(adapters["b"])})
        long_chat.join(LOOP_WAIT_S)
        expect(result.get("value", (0,))[0] == 200, f"the long adapter chat: {result}")
        for what, (st, body) in (("unload", busy_unload), ("replace", busy_replace)):
            err = body["workers"][SERVE_WORKER]["error"] if isinstance(body, dict) else body
            expect(st == 503 and "in-flight" in err, f"busy {what}: {st} {body}")
        wait_for(lambda: not engine._lora_slot_busy(slots["a"]), "the adapter lane to end")
        st_unload, _ = _http(port, "POST", "/unload_lora_adapter", {"lora_name": "a"})
        st_c, body_c = _http(port, "POST", "/load_lora_adapter",
                             {"lora_name": "c", "lora_path": str(adapters["a"])})
        reused = st_c == 200 and body_c["workers"][SERVE_WORKER].get("slot") == slots["a"]
        st, listed = _http(port, "GET", "/list_lora_adapters")
        st_gone, _ = _http(port, "POST", "/v1/chat/completions", {
            "model": model_id, "messages": chats["short"], "max_tokens": 4,
            "temperature": 0, "lora_adapter": "a"})
        out["unload"] = dict(busy_unload_status=busy_unload[0],
                             busy_replace_status=busy_replace[0], unload_after=st_unload,
                             slot_reused=reused, listed=listed["workers"][SERVE_WORKER],
                             unloaded_adapter_status=st_gone)
        expect(st_unload == 200 and reused and listed["workers"][SERVE_WORKER] == ["b", "c"]
               and st_gone != 200, f"unload after the lane ended: {out['unload']}")
        print(f"  [{label}] adapters: slots {slots}, {out['unload']}")
        # the gateway's tokenize
        out["tokenize"] = _tokenize_ms(ctx.tokenizers, model_id)
        t = out["tokenize"]
        print(f"  [{card}] {label} gateway tokenize of a {t['tokens']}-token chat: L1 miss "
              f"{t['miss_ms']:.3f} ms, L1 hit {t['l1_hit_ms']:.3f} ms, L0 hit "
              f"{t['l0_hit_ms']:.4f} ms; L1 {t['l1']}")
        audit_deadline = time.monotonic() + 10
        while not engine.audit()["clean"] and time.monotonic() < audit_deadline:
            time.sleep(0.05)
        expect(engine.audit()["clean"], f"audit after serving: {engine.audit()}")
    finally:
        held["loop"].call_soon_threadsafe(held["stop"].set)
        held["thread"].join(LOOP_WAIT_S)
    if held["thread"].is_alive():
        raise AssertionError("the gateway did not shut down")
    ctx.registry.remove(SERVE_WORKER)
    return out




# ---- phase 10: the rest of serve; embeddings, rerank and classify ----

EMBED_CAP = 4096  # the largest prefill bucket: embeddings are cut there
EMBED_TEXTS = 8  # texts of 200-1500 tokens in one /v1/embeddings request
EMBED_F32_ATOL = 1e-4  # float32: the tiled forward against one tile
# bf16 embeddings held to the float32 run's on the same (bf16-valued)
# weights: the rms of a row's difference at most this share of the row's
# rms (a unit row of 4096 has rms 1/64)
EMBED_BF16_REL = 0.1
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
CB_TIMEOUT_S = 4.0  # phase 10's breaker cool-down (--cb-timeout-duration-secs)
API_PAYLOAD = 1 << 16  # the breaker gateway's --max-payload-size
KV_AUDIT_KEYS = ("cached_pages", "total_pages", "free_pages", "radix_hit_pages",
                 "radix_miss_pages", "radix_evicted_pages", "cached_prompt_tokens",
                 "computed_prompt_tokens", "cache_hit_rate")
FAULT_ENGINES, FAULT_PAGES = 4, 256  # the workspace check: engines in a row, their KV
TRACE_KERNEL_CAT = "kernel"  # a CUDA kernel's event category in torch.profiler's trace


def _api_jobs(seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    texts = [_words(ids(int(n))) for n in rng.integers(200, 1501, EMBED_TEXTS)]
    shared = ids(600)
    return dict(texts=texts, id_lists=[ids(300), ids(EMBED_CAP)],
                shared=[shared + ids(40), shared + ids(60)],
                chats=[ids(100 + 10 * i) for i in range(8)])


def embed_work(cfg, lengths) -> dict:
    """Bytes and operations one ``forward_embed`` needs for rows of these
    real lengths: every layer's weights read once (the embedding rows
    gathered, the output written), the projections in the model's dtype,
    the causal attention in float32 (as computed)."""
    item = 2 if cfg.dtype == "bfloat16" else 4
    E, H, K, D, F, L = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.intermediate_size, cfg.num_layers)
    per_layer = E * H * D * 2 + 2 * E * K * D + 3 * E * F  # wq, wo, wk, wv, the MLP
    tokens = sum(lengths)
    proj = 2 * per_layer * L * tokens
    attn = sum(2 * H * D * n * (n + 1) for n in lengths) * L  # QK^T and PV, causal
    nbytes = per_layer * L * item + tokens * E * item + len(lengths) * E * 4
    peak = BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS
    ms = max(nbytes / HBM_BYTES_PER_S, proj / peak + attn / F32_FLOPS) * 1e3
    return dict(bytes=nbytes, proj_flops=proj, attn_flops=attn, bound_ms=ms,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S * 1e3 >= ms else "operations")


def _embed_timed(engine, batches, reps: int) -> dict:
    """``engine.embed`` timed with CUDA events (the median of ``reps``,
    after the calls before it warmed it) and its peak memory above what was
    allocated before it."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        engine.embed(batches)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return dict(ms=statistics.median(times), peak_bytes=torch.cuda.max_memory_allocated() - base)


def _embed_plain(engine, batches):
    """``engine.embed`` with the forward in one tile: every row and every
    query at once (the reference's shape)."""
    model = engine.runner.model
    cls_fwd = type(model).forward_embed
    model.forward_embed = lambda t, l: cls_fwd(model, t, l, token_tile=1 << 40, q_tile=1 << 40)
    try:
        return engine.embed(batches)
    finally:
        del model.forward_embed


def _serve_apps(apps: list) -> tuple:
    """Serve ``apps`` = [(aiohttp app, port)] on one event loop thread;
    returns (held: its loop and stop event, the thread)."""
    import asyncio
    import threading

    from aiohttp import web

    held: dict = {}

    async def serve():
        held["loop"], held["stop"] = asyncio.get_running_loop(), asyncio.Event()
        runners = []
        try:
            for app, port in apps:
                runner = web.AppRunner(app)
                await runner.setup()
                runners.append(runner)
                await web.TCPSite(runner, "127.0.0.1", port).start()
            held["up"] = True
            await held["stop"].wait()
        finally:
            for runner in reversed(runners):
                await runner.cleanup()

    t = threading.Thread(target=lambda: asyncio.run(serve()), name="api-gateways")
    t.start()
    wait_for(lambda: "up" in held or not t.is_alive(), "gateways start", timeout=60)
    if "up" not in held:
        raise AssertionError("the gateways did not start")
    return held, t


def mix_policy_runs(cfg, params, dev, label: str, strict: bool, stall_free: dict,
                    with_profile: bool) -> dict:
    """Phase 3's five requests on the graph path under
    ``prefill_mix_policy="throughput"`` and with the prefix cache off,
    against the stall-free graph run ``stall_free``: launches exact, audits
    clean (``serve_paths``), no prefix hit with the cache off; with
    ``strict`` (float32) the streams must be identical."""
    L = cfg.num_layers
    out = {}
    for name, sched in (("throughput", dict(prefill_mix_policy="throughput")),
                        ("prefix_off", dict(enable_prefix_cache=False))):
        r = serve_paths(cfg, params, dev, 32, paths=PATHS[:1], sched=sched,
                        with_profile=with_profile and name == "throughput")["graphs"]
        check_launches(r, L, f"{label}/{name}", plain=False)
        res = r["results"]
        cached = {rid: x.cached_tokens for rid, x in res.items()}
        if name == "prefix_off" and any(cached.values()):
            raise AssertionError(f"[{label}/prefix_off] cached tokens with no prefix cache: "
                                 f"{cached}")
        if name == "throughput" and cached["shared_b"] <= 0:
            raise AssertionError(f"[{label}/throughput] shared_b got no radix prefix hit")
        equal = sum(res[rid].token_ids == stall_free["results"][rid].token_ids
                    for rid in res)
        if any(x.output_tokens != 32 or x.finish_reason != "length" for x in res.values()):
            raise AssertionError(f"[{label}/{name}] wrong counts or finishes")
        if strict and equal != len(res):
            raise AssertionError(f"[{label}/{name}] streams differ from stall-free's "
                                 f"({equal} of {len(res)} equal)")
        loads = r["loads"]
        if loads["audit"]["leaked_pages"]:
            raise AssertionError(f"[{label}/{name}] leaked pages: {loads['audit']}")
        out[name] = dict(streams_equal=equal, launches=r["launches"], stats=r["stats"],
                         ttft_ms=r["timers"]["ttft_ms"],
                         ttft_capture_ms=r["timers"]["ttft_capture_ms"],
                         step_ms_max=max(r["step_ms"]), cached_tokens=cached,
                         profile=r.get("profile"))
        t, sf = r["timers"], stall_free["timers"]
        print(f"  [{label}/{name}] streams equal to stall-free's: {equal} of {len(res)}; "
              f"cached {cached}; the 1400-token prompt's TTFT "
              f"{t['ttft_ms']['long_chunked']:.2f} ms, graph captures inside it "
              f"{t['ttft_capture_ms']['long_chunked']:.2f} ms (stall-free "
              f"{sf['ttft_ms']['long_chunked']:.2f}, captures "
              f"{sf['ttft_capture_ms']['long_chunked']:.2f}); longest step "
              f"{max(r['step_ms']):.2f} ms (stall-free {max(stall_free['step_ms']):.2f})")
    return out


def _api_engine(cfg, params, dev, tok, pages: int):
    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=pages, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=EMBED_CAP,
                                  max_prefill_tokens=512, decode_horizon=4),
        model_id=SERVE_MODEL), params=params, device=dev, tokenizer=tok)


def phase_api(cfg, params, dev, card: str, label: str, strict: bool, stall_free: dict,
              sink: dict) -> dict:
    """Phase 10 on one dtype's weights: the mix policy and the prefix cache
    (``mix_policy_runs``); embeddings, rerank and classify through a
    gateway built from ``serve`` flags; ``/debug/router``,
    ``/debug/kv_index`` and the profile routes; a breaker opened by a
    stream that dies mid-decode; the cuBLAS workspaces of engines built in
    a row (bf16 only).  ``sink`` carries the bf16 embeddings to the
    float32 run, which holds them to its own."""
    import gc

    import torch

    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.faults import FAULTS
    from smg_tpu_torch.gateway.launch import build_context, gateway_options
    from smg_tpu_torch.gateway.server import build_app
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.gateway.workers import Worker
    from smg_tpu_torch.tokenizer import MockTokenizer

    t_phase = time.perf_counter()
    out = {"mix": mix_policy_runs(cfg, params, dev, label, strict, stall_free,
                                  with_profile=not strict)}
    if not strict and stall_free.get("profile"):
        prof = {"stall-free": stall_free["profile"]["device_ms_per_column"],
                "throughput": out["mix"]["throughput"]["profile"]["device_ms_per_column"]}
        out["decode_ms_per_column"] = prof
        print(f"  [{label}] decode device ms a column on 4 lanes: {prof}")
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    jobs = _api_jobs(10)
    engine = _api_engine(cfg, params, dev, tok, 2048)
    spare = _api_engine(cfg, params, dev, tok, FAULT_PAGES)
    parse = build_parser().parse_args
    api_args = parse(["serve", "--model-preset", SERVE_MODEL, "--request-id-headers",
                      "X-Smoke-Id"])
    cb_args = parse(["serve", "--model-preset", SERVE_MODEL, "--policy", "round_robin",
                     "--cb-failure-threshold", "1", "--cb-success-threshold", "1",
                     "--cb-timeout-duration-secs", str(CB_TIMEOUT_S),
                     "--retry-initial-backoff-ms", "1", "--max-payload-size", str(API_PAYLOAD)])
    api = build_context(engine, **gateway_options(api_args))
    cb = build_context(engine, **gateway_options(cb_args))
    cb.registry.add(Worker(worker_id="inproc-1", client=InProcWorkerClient(spare),
                           model_id=SERVE_MODEL, page_size=PS))
    ports = {"api": _free_port(), "cb": _free_port()}
    held, server = _serve_apps([
        (build_app(api, client_max_size=api_args.max_payload_size), ports["api"]),
        (build_app(cb, client_max_size=cb_args.max_payload_size), ports["cb"])])
    prof_dir = Path(tempfile.mkdtemp(prefix="smg_profile_"))
    try:
        out.update(_api_checks(cfg, engine, spare, tok, jobs, ports, api, cb, label,
                               strict, sink, prof_dir))
    finally:
        FAULTS.clear()
        held["loop"].call_soon_threadsafe(held["stop"].set)
        server.join(LOOP_WAIT_S)
        engine.stop(drain=True, timeout=30)
        spare.stop(drain=True, timeout=30)
        shutil.rmtree(prof_dir, ignore_errors=True)
    if server.is_alive():
        raise AssertionError("the gateways did not shut down")
    # aiohttp keeps finished apps, with their contexts: the workers go
    for ctx in (api, cb):
        for w in ctx.registry.list():
            ctx.registry.remove(w.worker_id)
    del engine, spare, api, cb
    gc.collect()
    torch.cuda.empty_cache()
    if not strict:
        out["workspaces"] = check_workspaces(cfg, params, dev, tok, label)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  [{label}] phase 10 took {out['seconds']:.1f} s ({card})")
    return out


def _api_checks(cfg, engine, spare, tok, jobs, ports, api, cb, label: str, strict: bool,
                sink: dict, prof_dir: Path) -> dict:
    import numpy as np

    from smg_tpu_torch.faults import FAULTS

    out = {}
    port = ports["api"]
    # (a) embeddings over HTTP against a direct engine.embed, bitwise
    texts, id_lists = jobs["texts"], jobs["id_lists"]
    text_ids = [tok.encode(t) for t in texts]
    st, body = _http(port, "POST", "/v1/embeddings", {"model": SERVE_MODEL, "input": texts},
                     headers={"X-Smoke-Id": f"emb-{label}"})
    if st != 200:
        raise AssertionError(f"[{label}] /v1/embeddings: {st} {body}")
    http_texts = np.array([d["embedding"] for d in body["data"]], np.float32)
    st2, body2 = _http(port, "POST", "/v1/embeddings", {"model": SERVE_MODEL, "input": id_lists})
    if st2 != 200:
        raise AssertionError(f"[{label}] /v1/embeddings (ids): {st2} {body2}")
    http_ids = np.array([d["embedding"] for d in body2["data"]], np.float32)
    direct_texts, direct_ids = engine.embed(text_ids), engine.embed(id_lists)
    for name, a, b in (("texts", http_texts, direct_texts), ("ids", http_ids, direct_ids)):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"[{label}] HTTP {name} embeddings differ from a direct "
                                 f"engine.embed (max {float(np.abs(a - b).max())})")
        if not np.all(np.isfinite(a)) or np.abs(np.linalg.norm(a, axis=-1) - 1).max() > 1e-3:
            raise AssertionError(f"[{label}] {name} embeddings not finite unit rows")
    n_tokens = sum(map(len, text_ids))
    if body["usage"]["prompt_tokens"] != n_tokens or \
            body2["usage"]["prompt_tokens"] != sum(map(len, id_lists)):
        raise AssertionError(f"[{label}] embedding usage {body['usage']} {body2['usage']}")
    plain = {"texts": _embed_plain(engine, text_ids), "ids": _embed_plain(engine, id_lists)}
    tiled_err = {"texts": float(np.abs(direct_texts - plain["texts"]).max()),
                 "ids": float(np.abs(direct_ids - plain["ids"]).max())}
    if strict and max(tiled_err.values()) > EMBED_F32_ATOL:
        raise AssertionError(f"[{label}] tiled embeddings {tiled_err} from one tile")
    out["embed"] = dict(lengths=[len(x) for x in text_ids], tiled_vs_plain=tiled_err,
                        bitwise_http=True)
    if strict and "embed_bf16" in sink:
        rel = {}
        for name, f32 in (("texts", direct_texts), ("ids", direct_ids)):
            d = sink["embed_bf16"][name] - f32
            rel[name] = float(np.max(np.sqrt((d * d).mean(-1))
                                     / np.sqrt((f32 * f32).mean(-1))))
        out["embed"]["bf16_row_rms_rel"] = rel
        print(f"  [bf16 vs f32] embedding rows: rms of the difference / rms of the row, "
              f"worst {rel}")
        if max(rel.values()) > EMBED_BF16_REL:
            raise AssertionError(f"bf16 embeddings {rel} from float32's, over {EMBED_BF16_REL}")
    elif not strict:
        sink["embed_bf16"] = {"texts": direct_texts, "ids": direct_ids}
    # readings: device ms against the operations bound, peak above the resident
    reps = 1 if strict else 3
    for name, batches, lengths in (("rows8", text_ids, [len(x) for x in text_ids]),
                                   ("row4096", [id_lists[1]], [EMBED_CAP])):
        t = _embed_timed(engine, batches, reps)
        w = embed_work(cfg, lengths)
        out["embed"][name] = dict(**t, **w)
        print(f"  [{label}] embed {name}: {t['ms']:.3f} ms device, bound "
              f"{w['bound_ms']:.3f} ms ({w['bound_by']}; projections "
              f"{w['proj_flops']:.4g} + attention {w['attn_flops']:.4g} operations), "
              f"peak {t['peak_bytes']} bytes above the resident; tiled vs one tile "
              f"max {tiled_err}")
    # (b) rerank with top_n, and classify
    docs = [texts[3], texts[4], texts[0], texts[5]]
    st, rr = _http(port, "POST", "/v1/rerank", {"model": SERVE_MODEL, "query": texts[0],
                                                "documents": docs, "top_n": 3})
    scores = [r["relevance_score"] for r in rr.get("results", [])]
    unit = direct_texts.astype(np.float64)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    cos = {i: float(unit[[3, 4, 0, 5][i]] @ unit[0]) for i in range(4)}
    if st != 200 or len(scores) != 3 or rr["results"][0]["index"] != 2 or \
            scores != sorted(scores, reverse=True) or abs(scores[0] - 1) > 1e-6 or \
            any(abs(r["relevance_score"] - cos[r["index"]]) > 1e-6 for r in rr["results"]):
        raise AssertionError(f"[{label}] /v1/rerank: {st} {rr}; direct cosines {cos}")
    st, cl = _http(port, "POST", "/v1/classify", {"model": SERVE_MODEL,
                                                  "input": [texts[1], texts[2]],
                                                  "labels": [texts[2], texts[1], texts[6]]})
    if st != 200 or [d["label"] for d in cl["data"]] != [texts[1], texts[2]] or \
            any(abs(sum(d["scores"].values()) - 1) > 1e-6 for d in cl["data"]):
        raise AssertionError(f"[{label}] /v1/classify: {st} {cl}")
    out["rerank_scores"], out["classify_ok"] = scores, True
    # (c) the shared-prefix decision, the kv-index audit, the profile routes
    for ids in jobs["shared"]:
        st, _ = _http(port, "POST", "/v1/chat/completions", _chat(ids, 8))
        if st != 200:
            raise AssertionError(f"[{label}] shared-prefix chat: {st}")
    st, router = _http(port, "GET", "/debug/router?limit=8")
    decisions = router["models"][SERVE_MODEL]["decisions"]
    last = decisions[-1]
    if st != 200 or last["policy"] != "cache_aware" or last["outcome"] != "prefix_hit" or \
            not last["reconciled"] or not last["predicted_match_tokens"] or \
            not last["worker_cached_tokens"]:
        raise AssertionError(f"[{label}] /debug/router's last decision: {st} {last}")
    if not any(d["request_id"] == f"emb-{label}" for d in decisions):
        raise AssertionError(f"[{label}] --request-id-headers: no decision of emb-{label}")
    st, kv = _http(port, "GET", "/debug/kv_index")
    loads = engine.loads()
    want = {k: loads[k] for k in KV_AUDIT_KEYS}
    if st != 200 or kv["workers"].get(SERVE_WORKER) != want:
        raise AssertionError(f"[{label}] /debug/kv_index {kv.get('workers')} != loads {want}")
    out["router_last"] = {k: last[k] for k in ("outcome", "predicted_match_tokens",
                                               "worker_cached_tokens",
                                               "prediction_error_tokens")}
    st1, b1 = _http(port, "POST", "/start_profile", {"output_dir": str(prof_dir)})
    st, _ = _http(port, "POST", "/v1/chat/completions", _chat(jobs["chats"][0], 8))
    st2, b2 = _http(port, "POST", "/stop_profile")
    traces = sorted(prof_dir.glob("trace-*.json"))
    kernels = 0
    if traces:
        kernels = sum(1 for ev in json.loads(traces[0].read_text())["traceEvents"]
                      if ev.get("cat") == TRACE_KERNEL_CAT)
    if (st1, st2) != (200, 200) or not b1["ok"] or not b2["ok"] or len(traces) != 1 or \
            kernels < 1:
        raise AssertionError(f"[{label}] profile routes: {st1} {b1} {st2} {b2}; traces "
                             f"{traces}, {kernels} kernel events")
    out["profile_kernel_events"] = kernels
    print(f"  [{label}] /debug/router last decision {out['router_last']}; /debug/kv_index "
          f"= loads() {want}; profile trace {traces[0].stat().st_size} bytes, {kernels} "
          "kernel events")
    # (d) the breaker: a stream that dies after its first chunk, on the
    # round-robin gateway over two workers
    port = ports["cb"]
    engines = {"inproc-0": engine, "inproc-1": spare}
    calls = lambda: {w: e.runner.stats["prefill_calls"] for w, e in engines.items()}  # noqa: E731
    state = lambda w: cb.registry.get(w).circuit.state.value  # noqa: E731
    # a chat on each worker first: their decode graphs are captured before
    # the cool-down's clock runs
    for ids in jobs["chats"][6:8]:
        if _http(port, "POST", "/v1/chat/completions", _chat(ids, 16))[0] != 200:
            raise AssertionError(f"[{label}] a warm-up chat on the breaker gateway failed")
    FAULTS.arm("worker.stream", mode="after", n=1, match=f"cb-poison-{label}")
    st, _ = _http(port, "POST", "/v1/chat/completions", _chat(jobs["chats"][1], 16),
                  headers={"X-Request-Id": f"cb-poison-{label}"})
    t_open = time.perf_counter()
    FAULTS.clear()
    opened = [w for w in engines if state(w) == "open"]
    if st != 502 or len(opened) != 1:
        raise AssertionError(f"[{label}] poisoned decode: {st}, breakers "
                             f"{ {w: state(w) for w in engines} }")
    bad = opened[0]
    c0 = calls()
    for ids in jobs["chats"][2:5]:
        if _http(port, "POST", "/v1/chat/completions", _chat(ids, 4))[0] != 200:
            raise AssertionError(f"[{label}] a chat with {bad}'s breaker open failed")
    c1 = calls()
    around_s = time.perf_counter() - t_open
    if around_s >= CB_TIMEOUT_S:
        raise AssertionError(f"[{label}] the chats around the open breaker took {around_s:.2f} "
                             f"s, past the {CB_TIMEOUT_S} s cool-down")
    if c1[bad] != c0[bad]:
        raise AssertionError(f"[{label}] {bad} served with its breaker open: {c0} -> {c1}")
    time.sleep(max(CB_TIMEOUT_S - around_s, 0) + 0.2)
    half = state(bad)
    for ids in jobs["chats"][5:8]:
        if _http(port, "POST", "/v1/chat/completions", _chat(ids + [7], 4))[0] != 200:
            raise AssertionError(f"[{label}] a chat after the cool-down failed")
        if state(bad) == "closed":
            break
    if half != "half_open" or state(bad) != "closed" or calls()[bad] == c1[bad]:
        raise AssertionError(f"[{label}] {bad}'s breaker: {half} after the cool-down, "
                             f"then {state(bad)}; prefill calls {c1} -> {calls()}")
    st, big = _http(port, "POST", "/v1/chat/completions",
                    {"model": SERVE_MODEL, "messages": [{"role": "user",
                                                         "content": "w5 " * API_PAYLOAD}]})
    if st != 400 or "Request Entity Too Large" not in str(big):
        raise AssertionError(f"[{label}] a body over --max-payload-size: {st} {big}")
    out["breaker"] = dict(worker=bad, opened=True, around_s=around_s, half_open=half,
                          closed=True)
    print(f"  [{label}] breaker of {bad}: opened by one failed decode, routed around "
          f"for {around_s:.2f} s (prefill calls {c0} -> {c1}), half-open after "
          f"{CB_TIMEOUT_S} s, closed by a "
          "probe; a body over --max-payload-size refused (400)")
    return out


def check_workspaces(cfg, params, dev, tok, label: str) -> dict:
    """``FAULT_ENGINES`` engines built, served and dropped in a row with
    graphs on (each on its own loop thread): ``memory_allocated`` after the
    last equals what it was after the second.  Then an engine that outlives
    another replays its graphs to the same streams and logprobs, bitwise,
    and to the eager path's tokens."""
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.protocols.sampling import SamplingParams

    def make(graphs: bool):
        return Engine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=PS, num_pages=FAULT_PAGES,
                                         auto_size=False, dtype=cfg.dtype),
            scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=1024,
                                      max_prefill_tokens=512, decode_horizon=4,
                                      overlap_schedule=graphs),
            decode_graphs=graphs), params=params, device=dev, tokenizer=tok)

    prompts = [list(range(2000 + 300 * i, 2100 + 300 * i)) for i in range(4)]

    def serve(eng):
        eng.start()
        outs = {i: [] for i in range(len(prompts))}
        for i, p in enumerate(prompts):
            eng.submit(p, SamplingParams(temperature=0.0, max_new_tokens=12, ignore_eos=True),
                       rid=f"ws{i}", on_output=outs[i].append)
        wait_for(lambda: all(o and o[-1].finished for o in outs.values())
                 and not eng.has_work(), "workspace check")
        eng.stop()
        return {i: ([t for x in o for t in x.new_token_ids], [x for y in o for x in y.logprobs])
                for i, o in outs.items()}

    allocated = []
    for _ in range(FAULT_ENGINES):
        eng = make(True)
        serve(eng)
        if not eng.loads()["decode_graphs"]:
            raise AssertionError("the workspace check's engine captured no graph")
        del eng
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(dev))
    print(f"  [{label}] memory_allocated after each of {FAULT_ENGINES} engines: {allocated}")
    if allocated[-1] != allocated[1]:
        raise AssertionError(f"engines in a row grew memory_allocated: {allocated}")
    eager = make(False)
    want = serve(eager)
    del eager
    keep = make(True)
    before = serve(keep)
    other = make(True)
    serve(other)
    del other
    gc.collect()
    keep.flush_cache()
    after = serve(keep)
    tokens_eager = all(after[i][0] == want[i][0] for i in want)
    lps_eager = all(after[i][1] == want[i][1] for i in want)
    if after != before or not tokens_eager:
        raise AssertionError("a surviving engine's replays changed after another engine "
                             f"ended (tokens equal to eager: {tokens_eager})")
    print(f"  [{label}] a surviving engine replayed bitwise after another ended; tokens "
          f"equal to the eager path's, logprobs bitwise equal too: {lps_eager}")
    del keep
    gc.collect()
    torch.cuda.empty_cache()
    return dict(allocated=allocated, growth_after_second=allocated[-1] - allocated[1],
                survivor_bitwise=True, logprobs_equal_eager=lps_eager)


# ---- phase 9: the Qwen-MoE family on Qwen3-30B-A3B ----

# the published config.json of Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B)
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
    "hidden_size": 2048, "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_hidden_layers": 48, "num_attention_heads": 32, "num_key_value_heads": 4,
    "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [], "vocab_size": 151936,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-06, "max_position_embeddings": 40960,
    "tie_word_embeddings": False, "bos_token_id": 151643, "eos_token_id": 151645,
    "hidden_act": "silu", "attention_bias": False, "torch_dtype": "bfloat16",
}
MOE_WEIGHT_BYTES = 61_064_245_248  # 30,532,122,624 parameters in bf16
MOE_LEFT_BYTES = 1 << 30  # what earlier phases may leave allocated before phase 9
MOE_F32_LAYERS = 8  # float32 at 48 layers needs 122 GB: the depth of the float32 run
MOE_CKPT_LAYERS = 2  # the written checkpoint's depth: spares the disk and the card
MOE_CKPT = "qwen3-30b-a3b-hf"
MOE_CHAT_NEW = 16  # new tokens of every phase-9 chat
MOE_LANES = 4  # the decode profile's lanes (profile_decode)
MOE_KV_TOKENS = 1000  # each profiled lane's context, at least (its prompt)
# the expert layer against the gathered per-token computation: float32
# differs in summation order only; bf16 rounds g, u, their product and y to
# bf16 on the way (a few bf16 ulps), held as the kernels are
MOE_F32_RTOL = 1e-4
QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")  # ids 151643-151645
CHATML_TEMPLATE = (
    "{%- for message in messages %}{{- '<|im_start|>' + message['role'] + '\\n' + "
    "message['content'] + '<|im_end|>' + '\\n' }}{%- endfor %}{%- if add_generation_prompt "
    "%}{{- '<|im_start|>assistant\\n' }}{%- endif %}")
MOE_SPANS = ("moe_route", "moe_experts", "moe_combine")


@contextlib.contextmanager
def moe_annotations():
    """The expert layer's three steps (``models/llama.py``) inside profiler
    ranges while the block runs, so an eager trace splits their kernels by
    step (``device_time``'s classes).  A graph replay has no ranges: its
    kernels count as the rest."""
    from torch.profiler import record_function

    from smg_tpu_torch.models import llama

    orig = {name: getattr(llama, name) for name in MOE_SPANS}

    def ranged(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    for name, fn in orig.items():
        setattr(llama, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(llama, name, fn)


def _nbytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for group in (params, params["layers"])
               for k, t in group.items() if k != "layers")


def moe_work(cfg, params) -> dict:
    """Bytes and operations of the MoE model: weight bytes by kind, and per
    token the operations of dense dispatch (every expert) and of the k
    routed experts alone (attention scores aside)."""
    L, X, E = cfg.num_layers, cfg.num_experts, cfg.hidden_size
    H, K, D, Fm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.moe_intermediate_size
    ly = params["layers"]
    experts = sum(ly[k].numel() * ly[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    embed = params["embed"].numel() * params["embed"].element_size()
    total = _nbytes(params)
    attn_ops = 2 * E * (H + 2 * K) * D + 2 * H * D * E + 2 * E * X  # projections, router
    expert_ops = 3 * 2 * E * Fm  # one expert on one token
    return dict(total=total, experts=experts, per_expert=experts // (L * X),
                embed=embed, non_expert=total - experts - embed,
                dense_ops_per_token=L * (attn_ops + X * expert_ops),
                active_ops_per_token=L * (attn_ops + cfg.num_experts_per_tok * expert_ops),
                kv_bytes_per_token=L * 2 * K * D * 2)


def moe_prefill_ops(cfg, work: dict, tokens: int, dense: bool = True) -> float:
    """Operations of a cold prefill of ``tokens``: every token's layers and
    its causal attention scores (QK and PV over its context)."""
    per = work["dense_ops_per_token" if dense else "active_ops_per_token"]
    scores = 4 * cfg.num_heads * cfg.head_dim * cfg.num_layers * tokens * (tokens + 1) / 2
    return per * tokens + scores


def distinct_experts(engine, cfg, lanes: int = MOE_LANES) -> dict:
    """Distinct experts the ``lanes`` real rows of each decode column route
    to, per layer, counted on the device: one eager megastep of 4 lanes
    with ``moe_route`` recording its expert ids."""
    import torch

    from smg_tpu_torch.models import llama
    from smg_tpu_torch.protocols.sampling import SamplingParams

    sched = engine.scheduler
    outs = {f"x{i}": [] for i in range(lanes)}
    for i, rid in enumerate(outs):
        engine.submit(list(range(3000 + 1000 * i, 3000 + 1000 * i + MOE_KV_TOKENS)),
                      SamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True),
                      rid=rid, on_output=outs[rid].append)
    while sched.waiting or any(r is not None and r.status.value == "prefilling"
                               for r in sched.slots):
        engine.step()
    seen = []
    route = llama.moe_route

    def recording(x, router, k):
        idx, probs = route(x, router, k)
        seen.append(idx[:lanes])
        return idx, probs

    llama.moe_route = recording
    try:
        cols0 = engine.runner.stats["decode_columns"]
        engine.step()
        cols = engine.runner.stats["decode_columns"] - cols0
    finally:
        llama.moe_route = route
    while engine.has_work():
        engine.step()
    L, X = cfg.num_layers, cfg.num_experts
    idx = torch.stack(seen)  # [cols * L, lanes, k], column by column
    hit = torch.zeros((idx.shape[0], X), dtype=torch.int32, device=idx.device)
    hit.scatter_(1, idx.reshape(idx.shape[0], -1), 1)
    per_layer = hit.sum(dim=1).reshape(-1, L)  # [cols, L] on the device
    counts = per_layer.cpu()
    return dict(columns=cols, per_column=counts.sum(dim=1).tolist(),
                max_per_layer=int(counts.max()), min_per_layer=int(counts.min()),
                mean_per_layer=float(counts.float().mean()))


def moe_ttft(engine, dev, cfg, reps: int = 2) -> dict:
    """The 1400-token prompt alone through the loop thread (a fresh prompt
    each rep, so no radix hit): submit to first token, and the peak memory
    the prefill allocated above what was resident before it; then its
    chunked prefill forward (the engine's 512-token chunks) timed on the
    device with a cold L2."""
    import numpy as np
    import torch

    from smg_tpu_torch.protocols.sampling import SamplingParams

    rng = np.random.default_rng(99)
    times = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    engine.start()
    try:
        for r in range(reps):
            ids = rng.integers(1000, 120000, 1400).tolist()
            got = {}

            def cb(o, got=got):
                if o.new_token_ids and "t" not in got:
                    got["t"] = time.perf_counter()
                if o.finished:
                    got["done"] = True

            t0 = time.perf_counter()
            engine.submit(ids, SamplingParams(temperature=0.0, max_new_tokens=1,
                                              ignore_eos=True), rid=f"ttft{r}", on_output=cb)
            wait_for(lambda got=got: "done" in got and not engine.has_work(), "TTFT request")
            times.append((got["t"] - t0) * 1e3)
    finally:
        engine.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    runner, model = engine.runner, engine.runner.model
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    toks = i32(rng.integers(1000, 120000, 1400).tolist())
    pt = torch.arange(1, runner.max_pages_per_seq + 1, dtype=torch.int32, device=dev)
    step = runner.config.scheduler.max_prefill_tokens

    def prefill():
        for p in range(0, 1400, step):
            n = min(step, 1400 - p)
            model.forward_prefill(toks[p:p + n], i32([p]), i32([n]), runner.k_cache,
                                  runner.v_cache, pt, compute_logits=p + n == 1400)

    prefill_ms = cuda_ms(prefill, warmup=1, reps=3)
    engine.flush_cache()  # the timed forward wrote over free pages
    return dict(ttft_ms=statistics.median(times), ttft_ms_all=times,
                prefill_peak_bytes=peak, prefill_device_ms=prefill_ms,
                prefill_chunks=math.ceil(1400 / step))


def moe_reference(x, router, wg, wu, wd, k: int):
    """The expert layer computed another way, in float32: each token's top-k
    (the reference's routing: logits in the input's dtype, then float32,
    ``topk``, a softmax over the k), then for each routed expert only the
    tokens routed to it, gathered, through that expert's float32 weights,
    and added back with their gate weights.  Returns ([T, E] float32, the
    expert ids [T, k])."""
    import torch
    import torch.nn.functional as F

    logits = torch.matmul(x, router).float()
    vals, idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    xf = x.float()
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in idx.unique().tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        xs = xf[tok]
        y = (F.silu(xs @ wg[e].float()) * (xs @ wu[e].float())) @ wd[e].float()
        out.index_add_(0, tok, y * probs[tok, slot, None])
    return out, idx


def _hold(name: str, got, want, rms_atol: float, rtol: float) -> float:
    """``got`` within rms_atol x its row's rms plus rtol x |want| of want."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = rms_atol * rms + rtol * w.abs()
    share = float((err / limit.clamp(min=1e-30)).max())
    mx = float(err.max())
    print(f"  {name}: max_abs_err={mx:.3e} (largest share of its limit {share:.3f}, "
          f"row rms {float(rms.min()):.3e}..{float(rms.max()):.3e}) "
          f"{'ok' if share <= 1 else 'FAIL'}")
    if share > 1:
        raise AssertionError(f"{name}: {mx:.3e} outside its limit")
    return mx


def check_expert_layer(cfg, params, dev, card: str, layer: int = 1) -> dict:
    """Phase 9 (c): ``moe_mlp`` of one layer at T=512 and B=4 against
    ``moe_reference``, in float32 (the layer widened) and in bf16; with
    the bf16 layer's device time, its bounds (dense dispatch reads every
    expert once; T=512 does 512 tokens' dense operations) and the distinct
    experts 4 random tokens route to."""
    import torch

    from smg_tpu_torch.models.llama import moe_mlp

    ly = params["layers"]
    w16 = [ly[k][layer] for k in ("router", "w_gate", "w_up", "w_down")]
    w32 = [t.float() for t in w16]
    k = cfg.num_experts_per_tok
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for T in (512, 4):
        x = torch.randn((T, cfg.hidden_size), generator=gen, device=dev).bfloat16()
        want32, idx32 = moe_reference(x.float(), *w32, k)
        got32 = moe_mlp(x.float(), *w32, k)
        err32 = _hold(f"expert layer T={T} float32", got32, want32, MOE_F32_RTOL,
                      MOE_F32_RTOL)
        want16, idx16 = moe_reference(x, *w16, k)
        got16 = moe_mlp(x, *w16, k)
        err16 = _hold(f"expert layer T={T} bf16", got16, want16, KERNEL_RMS_ATOL,
                      KERNEL_RTOL)
        ms = cuda_ms(lambda x=x: moe_mlp(x, *w16, k))
        nbytes = sum(t.numel() * t.element_size() for t in w16) + 2 * x.numel() * 2
        ops = T * (2 * cfg.hidden_size * cfg.num_experts
                   + cfg.num_experts * 6 * cfg.hidden_size * cfg.moe_intermediate_size)
        bms, by = bound_ms(nbytes, ops)
        out[f"T{T}"] = dict(max_abs_err_f32=err32, max_abs_err_bf16=err16, ms=ms,
                            bound_ms=bms, bound_by=by,
                            distinct_experts=int(idx16.unique().numel()))
        print(f"  [{card}] expert layer T={T} (bf16, one layer): {ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}); {out[f'T{T}']['distinct_experts']} distinct experts "
              f"routed")
    del w32
    torch.cuda.empty_cache()
    return out


def moe_readings(label: str, engine, cfg, dev, card: str, sink: dict):
    """``serve_paths``' hook on phase 9's engines: the TTFT, prefill memory
    and prefill device time on the serving path, the routed experts of a
    4-lane decode column on the eager one."""
    if label == "graphs":
        r = moe_ttft(engine, dev, cfg)
        print(f"  [{card}] 1400-token prompt alone: TTFT {r['ttft_ms']:.2f} ms "
              f"({r['ttft_ms_all']}), prefill device {r['prefill_device_ms']:.2f} ms in "
              f"{r['prefill_chunks']} chunks, prefill peak {r['prefill_peak_bytes']} bytes "
              f"above the resident")
        sink.update(r)
    elif label == "eager":
        r = distinct_experts(engine, cfg)
        print(f"  [{card}] distinct experts a 4-lane decode column routes to: "
              f"{r['per_column']} over {cfg.num_layers} layers (per layer "
              f"{r['min_per_layer']}..{r['max_per_layer']}, mean {r['mean_per_layer']:.2f})")
        sink["distinct"] = r
    return None


def moe_report(cfg, work: dict, runs, sink: dict, card: str) -> dict:
    """Decode device ms a column and its op classes against the dense and
    the touched bounds; the prompt's TTFT and prefill device ms against
    dense dispatch's operations; tokens/s."""
    g, e = runs["graphs"]["profile"], runs["eager"]["profile"]
    kv = MOE_LANES * MOE_KV_TOKENS * work["kv_bytes_per_token"]
    dense_bytes = work["non_expert"] + work["experts"] + kv
    d = sink["distinct"]
    touched_cols = [work["non_expert"] + n * work["per_expert"] + kv for n in d["per_column"]]
    touched = max(touched_cols)
    ops = moe_prefill_ops(cfg, work, 1400)
    active = moe_prefill_ops(cfg, work, 1400, dense=False)
    out = dict(
        decode_device_ms_per_column=g["device_ms_per_column"],
        decode_busy_share=g["busy_share"],
        decode_replay_ms_per_column=g.get("replay_ms_per_column"),
        decode_eager_device_ms_per_column=e["device_ms_per_column"],
        decode_eager_by_class_ms=e["by_class_ms_per_column"],
        decode_graph_by_class_ms=g["by_class_ms_per_column"],
        dense_bytes_per_column=dense_bytes, dense_bound_ms=dense_bytes / HBM_BYTES_PER_S * 1e3,
        touched_bytes_per_column=touched, touched_bound_ms=touched / HBM_BYTES_PER_S * 1e3,
        kv_bytes_per_column=kv, distinct_experts=d,
        ttft_ms=sink["ttft_ms"], prefill_device_ms=sink["prefill_device_ms"],
        prefill_peak_bytes=sink["prefill_peak_bytes"],
        prefill_dense_ops=ops, prefill_dense_bound_ms=ops / BF16_FLOPS * 1e3,
        prefill_active_ops=active, prefill_active_bound_ms=active / BF16_FLOPS * 1e3,
        decode_tok_s=g["decode_tok_s"],
        serve_tok_s={k: sum(r.output_tokens for r in v["results"].values()) / v["wall_s"]
                     for k, v in runs.items()},
    )
    print(f"  [{card}] MoE decode on {MOE_LANES} lanes: {out['decode_device_ms_per_column']:.3f}"
          f" device ms/column (busy share {out['decode_busy_share']:.3f}); dense dispatch "
          f"moves {dense_bytes} bytes a column, bound {out['dense_bound_ms']:.3f} ms; the "
          f"routed experts alone {touched} bytes, bound {out['touched_bound_ms']:.3f} ms")
    print(f"  [{card}] eager decode by op class (ms/column): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(out["decode_eager_by_class_ms"].items())))
    print(f"  [{card}] 1400-token prompt: TTFT {out['ttft_ms']:.2f} ms, prefill device "
          f"{out['prefill_device_ms']:.2f} ms against dense dispatch's {ops:.4e} operations "
          f"({out['prefill_dense_bound_ms']:.2f} ms; the routed experts alone "
          f"{out['prefill_active_bound_ms']:.2f} ms); serve tokens/s {out['serve_tok_s']}")
    return out


def write_qwen_tokenizer(path: Path, vocab_size: int) -> None:
    """A word-level ``tokenizer.json`` of ``vocab_size`` ids: ``w<id>`` below
    151643 (the last four ``<unk>``, ``system``, ``user``, ``assistant``),
    Qwen's special tokens at 151643-151645 and reserved specials above; a
    ``tokenizer_config.json`` with a ChatML template, no BOS and
    ``<|im_end|>`` as EOS, as Qwen's."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers

    n = QWEN3_30B_A3B["bos_token_id"]  # 151643: the first special
    vocab = {f"w{i}": i for i in range(n - 4)}
    vocab.update({w: n - 4 + j for j, w in enumerate(("<unk>", "system", "user",
                                                       "assistant"))})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    specials = list(QWEN_SPECIALS) + [f"<|reserved_{j}|>"
                                      for j in range(vocab_size - n - len(QWEN_SPECIALS))]
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False) for s in specials])
    if tok.get_vocab_size() != vocab_size or tok.token_to_id("<|im_end|>") != n + 2:
        raise AssertionError(f"tokenizer vocabulary {tok.get_vocab_size()} != {vocab_size}")
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": None, "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
        "chat_template": CHATML_TEMPLATE}))


def write_moe_checkpoint(host: dict, path: Path, layers: int) -> dict:
    """The first ``layers`` layers of ``host`` (the port's layout, bf16, on
    the host) as a Qwen3-MoE HF directory: the published ``config.json``
    at that depth, the linears as ``[out, in]``, each expert's three as
    tensors of their own, in 2 safetensors files with an index, and the
    tokenizer."""
    from safetensors.torch import save_file

    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(dict(QWEN3_30B_A3B,
                                                      num_hidden_layers=layers)))
    ly = host["layers"]
    names = dict(HF_LAYER, q_norm=("self_attn.q_norm", False),
                 k_norm=("self_attn.k_norm", False), router=("mlp.gate", True))
    t0 = time.perf_counter()
    weight_map, nbytes, tensors = {}, 0, 0
    half = math.ceil(layers / 2)
    for s, span in enumerate((range(half), range(half, layers))):
        part = {}
        if s == 0:
            part["model.embed_tokens.weight"] = host["embed"]
        for i in span:
            for key, (name, linear) in names.items():
                if key in ("w_gate", "w_up", "w_down"):
                    continue
                t = ly[key][i]
                part[f"model.layers.{i}.{name}.weight"] = (t.t() if linear else t).contiguous()
            for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                              ("w_down", "down_proj")):
                for e in range(ly[key].shape[1]):
                    part[f"model.layers.{i}.mlp.experts.{e}.{proj}.weight"] = \
                        ly[key][i, e].t().contiguous()
        if s == 1:
            part["model.norm.weight"] = host["final_norm"]
            part["lm_head.weight"] = host["lm_head"].t().contiguous()
        fname = f"model-{s + 1:05d}-of-00002.safetensors"
        save_file(part, str(path / fname), metadata={"format": "pt"})
        nbytes += sum(t.numel() * t.element_size() for t in part.values())
        tensors += len(part)
        weight_map.update({k: fname for k in part})
        del part
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": nbytes}, "weight_map": weight_map}))
    write_qwen_tokenizer(path, QWEN3_30B_A3B["vocab_size"])
    return dict(tensor_bytes=nbytes, tensors=tensors, layers=layers,
                write_s=time.perf_counter() - t0,
                file_bytes=sum(f.stat().st_size for f in path.glob("*.safetensors")))


def write_moe_from_card(params: dict, path: str, layers: int) -> dict:
    """``write_moe_checkpoint`` of ``params`` (the first ``layers`` layers,
    on the card) after copying them to the host here."""
    host = {k: v.cpu() for k, v in params.items() if k != "layers"}
    host["layers"] = {k: v[:layers].cpu() for k, v in params["layers"].items()}
    return write_moe_checkpoint(host, Path(path), layers)


def _to_card(host: dict, dev, layers: int) -> dict:
    out = {k: v.to(dev) for k, v in host.items() if k != "layers"}
    out["layers"] = {k: v[:layers].to(dev) for k, v in host["layers"].items()}
    return out


def serve_moe_checkpoint(cfg, host: dict, path: Path, dev, card: str, dtype: str) -> dict:
    """Phase 9 (d) in one dtype: the direct engine's greedy tokens for two
    chats (a short one and a 1400-token one) on the in-memory weights, then
    ``serve --model-path`` on the written directory: its tensors against
    the in-memory ones (bitwise, a bf16 file widened exactly for float32)
    and the HTTP chats' texts against the direct tokens (exact in
    float32)."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.tokenizer.hf import HFTokenizer

    layers = MOE_CKPT_LAYERS
    cfg_d = dataclasses.replace(cfg, num_layers=layers, dtype=dtype)
    if ModelConfig.from_pretrained(str(path), dtype=dtype) != cfg_d:
        raise AssertionError("the written config.json does not read back as the model's")
    tok = HFTokenizer(str(path))
    chats = _ckpt_chats(41)
    ids = {k: tok.encode(tok.apply_chat_template(m)) for k, m in chats.items()}
    params = _to_card(host, dev, layers)
    if dtype == "float32":
        _widen(params)
    direct = Engine(EngineConfig(
        model=cfg_d, cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=False,
                                       dtype=dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4)), params=params, device=dev)
    direct.start()
    try:
        ref = {}
        for k, p in ids.items():
            ref.update(_direct(direct, [(k, p, MOE_CHAT_NEW)]))
    finally:
        direct.stop()
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    engine, ctx, port, held, load_s = _serve_dir(path, dtype, dev)
    out = dict(load_s=load_s, pages=engine.runner.spec.num_pages)
    try:
        loaded = engine.runner.model
        same = {k: torch.equal(getattr(loaded, k), v) for k, v in params.items()
                if k != "layers"}
        same.update({f"layers/{k}": torch.equal(getattr(loaded.layers, k), v)
                     for k, v in params["layers"].items()})
        del loaded
        out["weights_bitwise_equal"] = all(same.values())
        if not all(same.values()):
            raise AssertionError(f"loaded tensors differ: {[k for k, v in same.items() if not v]}")
        http = {}
        for k, msgs in chats.items():
            _http(port, "POST", "/flush_cache")
            st, body = _http(port, "POST", "/v1/chat/completions", {
                "model": engine.config.model_id, "messages": msgs,
                "max_tokens": MOE_CHAT_NEW, "temperature": 0, "ignore_eos": True})
            if st != 200:
                raise AssertionError(f"chat {k}: {st} {body}")
            http[k] = (body["choices"][0]["message"]["content"],
                       body["usage"]["completion_tokens"], body["usage"]["prompt_tokens"])
        agree = {k: http[k] == (tok.decode(ref[k][0]), MOE_CHAT_NEW, len(ids[k]))
                 for k in chats}
        out.update(http_equal_direct=agree, prompt_tokens={k: len(v) for k, v in ids.items()})
        print(f"  [{card}] {dtype} serve --model-path ({layers} layers): load "
              f"{load_s:.3f} s, {out['pages']} KV pages, weights bitwise equal "
              f"{out['weights_bitwise_equal']}, HTTP chats equal the direct engine's {agree} "
              f"(prompts {out['prompt_tokens']} tokens)")
        if dtype == "float32" and not all(agree.values()):
            raise AssertionError(f"float32 HTTP chats differ from the direct engine: {agree}")
        deadline = time.monotonic() + 10
        while not engine.audit()["clean"] and time.monotonic() < deadline:
            time.sleep(0.05)
        if not engine.audit()["clean"]:
            raise AssertionError(f"audit after serving: {engine.audit()}")
    finally:
        held["loop"].call_soon_threadsafe(held["stop"].set)
        held["thread"].join(LOOP_WAIT_S)
    if held["thread"].is_alive():
        raise AssertionError("the gateway did not shut down")
    ctx.registry.remove(SERVE_WORKER)
    del engine, ctx, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _row_rms_err(runs, ref) -> dict:
    """Each path's first-token logits against ``ref``: the mean over rows of
    each row's rms error."""
    return {name: statistics.mean(float((a - b).pow(2).mean().sqrt())
                                  for a, b in zip(r["logits"], ref))
            for name, r in runs.items()}


def moe_depth_cut(cfg, host: dict, dev, card: str) -> dict:
    """Phase 9 (b): the first ``MOE_F32_LAYERS`` layers through the three
    paths in bf16 and then widened to float32.  Float32 streams identical
    across the paths and logits within ``F32_LOGIT_ATOL``; bf16's
    first-token logits held to the float32 run's (row rms), the kernel
    paths at most ``BF16_ERR_RATIO`` times as far as the plain one."""
    import dataclasses
    import gc

    import torch

    N, max_new = MOE_F32_LAYERS, 32
    cfg_n = dataclasses.replace(cfg, num_layers=N)
    params = _to_card(host, dev, N)
    runs16 = serve_paths(cfg_n, params, dev, max_new, auto_size=True)
    out = {"bf16_agreement": check_runs(runs16, N, max_new, f"moe bf16 {N} layers")}
    _widen(params)
    cfg32 = dataclasses.replace(cfg_n, dtype="float32")
    runs32 = serve_paths(cfg32, params, dev, max_new, auto_size=True)
    agree = check_runs(runs32, N, max_new, f"moe f32 {N} layers")
    out["f32_agreement"] = agree
    out["f32"] = summarize(runs32, card, f"moe f32 {N} layers")
    n = len(runs32["plain"]["results"])
    if agree["streams_equal"] != {k: n for k in agree["streams_equal"]} or \
            max(agree["logit_gap"].values()) > F32_LOGIT_ATOL:
        raise AssertionError(f"moe f32 paths disagree: {agree}")
    err = _row_rms_err(runs16, runs32["plain"]["logits"])
    out["bf16_row_rms_err_vs_f32"] = err
    print(f"  [bf16, {N} layers] first-token logits against the f32 run (mean row rms): "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    if not max(err["graphs"], err["eager"]) <= BF16_ERR_RATIO * err["plain"]:
        raise AssertionError(f"bf16 kernel logits {err} from the f32 run, more than "
                             f"{BF16_ERR_RATIO} x the plain version's")
    del runs16, runs32, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe(dev, card: str, side: "SideWorker") -> dict:
    """Phase 9: Qwen3-30B-A3B at full width and depth (random bf16 weights
    from seed 0, made on the card; auto-sized KV) through phase 3's three
    paths; (c) the expert layer against a gathered computation; (b) the
    depth-cut float32 run; (d) ``serve --model-path`` on a written
    Qwen3-MoE directory, written by ``side`` beside (a)-(c)."""
    import gc

    import torch

    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.models.llama import init_params

    gc.collect()
    torch.cuda.empty_cache()
    cleared = torch.cuda.memory_allocated(dev)
    # every earlier engine is gone, so the last of them released the cuBLAS
    # workspaces its graphs read (engine/graphs.py): nothing is cleared here
    print(f"  allocated before phase 9: {cleared} bytes")
    if cleared > MOE_LEFT_BYTES:
        live = sorted(((t.numel() * t.element_size(), tuple(t.shape), str(t.dtype))
                       for t in gc.get_objects()
                       if torch.is_tensor(t) and t.is_cuda), reverse=True)[:10]
        raise AssertionError(f"earlier phases left {cleared} bytes on the card; the "
                             f"largest live tensors: {live}")
    cfg = ModelConfig.from_hf_config(QWEN3_30B_A3B, dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    work = moe_work(cfg, params)
    out = dict(card=card, weight_bytes=work["total"], init_s=init_s, work=work,
               free_after_weights=torch.cuda.mem_get_info(dev)[0])
    print(f"  [{card}] Qwen3-30B-A3B: {work['total']} bytes of bf16 weights "
          f"({work['experts']} in experts) made in {init_s:.2f} s; "
          f"{out['free_after_weights']} bytes free")
    if work["total"] != MOE_WEIGHT_BYTES:
        raise AssertionError(f"weight bytes {work['total']} != {MOE_WEIGHT_BYTES}")
    L, max_new = cfg.num_layers, 32
    sink: dict = {}
    secs = out["seconds"] = {}
    t0 = time.perf_counter()
    # (d)'s directory is written by a process of its own beside (a)-(c),
    # started before (a) sizes its KV from the free memory
    root = Path(tempfile.mkdtemp(prefix="smg_moe_"))
    first = {**{k: v for k, v in params.items() if k != "layers"},
             "layers": {k: v[:MOE_CKPT_LAYERS] for k, v in params["layers"].items()}}
    writer = side.submit(write_moe_from_card, first, str(root / MOE_CKPT), MOE_CKPT_LAYERS)
    del first
    try:
        _moe_abc(cfg, params, dev, card, out, sink, secs, t0, writer, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 9 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return out


def _moe_abc(cfg, params, dev, card: str, out: dict, sink: dict, secs: dict, t0: float,
             writer, root: Path) -> None:
    """Phase 9's (a), (c), (b) and (d) on ``params`` (cleared after (c)),
    their readings into ``out``; (d)'s directory from ``writer``."""
    import gc

    import torch

    L, max_new = cfg.num_layers, 32
    # the plain path runs at MOE_F32_LAYERS in (b), where its logits are the
    # reference; at full depth it would only repeat that
    with moe_annotations():
        runs = serve_paths(cfg, params, dev, max_new, with_profile=True, auto_size=True,
                           paths=PATHS[:2],
                           after=lambda label, e: moe_readings(label, e, cfg, dev, card,
                                                               sink))
    out["agreement"] = check_runs(runs, L, max_new, "moe bf16")
    out["paths"] = summarize(runs, card, "moe bf16")
    out["pages"] = {k: r["pages"] for k, r in runs.items()}
    out["launches"] = runs["graphs"]["launches"]
    out["schedule"] = runs["graphs"]["stats"]
    out["readings"] = moe_report(cfg, out["work"], runs, sink, card)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    secs["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    print("phase 9 (c): the expert layer against a gathered computation")
    out["expert_layer"] = check_expert_layer(cfg, params, dev, card)
    # the first layers stay on the host while the full model goes
    keep = max(MOE_F32_LAYERS, MOE_CKPT_LAYERS)
    host = {k: v.cpu() for k, v in params.items() if k != "layers"}
    host["layers"] = {k: v[:keep].cpu() for k, v in params["layers"].items()}
    # the writer is done with the weights it shares before they go
    ckpt_files = writer.result()
    torch.cuda.ipc_collect()
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    secs["c"], t0 = time.perf_counter() - t0, time.perf_counter()
    print(f"phase 9 (b): the first {MOE_F32_LAYERS} layers, bf16 and float32")
    out["depth_cut"] = moe_depth_cut(cfg, host, dev, card)
    secs["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    print(f"phase 9 (d): serve --model-path on a {MOE_CKPT_LAYERS}-layer Qwen3-MoE "
          "directory")
    out["ckpt_files"] = f = ckpt_files
    print(f"  checkpoint: {f['tensors']} tensors, {f['file_bytes']} bytes in 2 files, "
          f"written in {f['write_s']:.1f} s beside (a)-(c)")
    out["ckpt"] = {dt: serve_moe_checkpoint(cfg, host, root / MOE_CKPT, dev, card, dt)
                   for dt in ("bfloat16", "float32")}
    secs["d"] = time.perf_counter() - t0


# ---- phase 12: Qwen2-VL-7B, the vision tower and image requests ----

# Qwen2-VL-7B-Instruct's published config.json, copied by value:
# https://huggingface.co/Qwen/Qwen2-VL-7B-Instruct/blob/main/config.json
QWEN2_VL_7B = {
    "architectures": ["Qwen2VLForConditionalGeneration"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "vision_start_token_id": 151652,
    "vision_end_token_id": 151653, "vision_token_id": 151654, "image_token_id": 151655,
    "video_token_id": 151656, "hidden_act": "silu", "hidden_size": 3584,
    "initializer_range": 0.02, "intermediate_size": 18944, "max_position_embeddings": 32768,
    "max_window_layers": 28, "model_type": "qwen2_vl", "num_attention_heads": 28,
    "num_hidden_layers": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 32768, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "transformers_version": "4.41.2", "use_cache": True,
    "use_sliding_window": False,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16,
                      "in_chans": 3, "hidden_size": 3584, "patch_size": 14,
                      "spatial_merge_size": 2, "spatial_patch_size": 14,
                      "temporal_patch_size": 2},
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vocab_size": 152064,
}
# (query heads, KV heads, head_dim, M-RoPE sections, tower width, tower depth)
VL_SHAPE = (28, 4, 128, (16, 24, 24), 1280, 32)
VL_IMAGE_TOKEN = 151655
# raw images (height, width) made from a seed each: two at 448 x 448 (1024
# patches, 256 tokens) and one at the processor's max_pixels (1120 x 896 =
# 1,003,520 pixels: 5120 patches, 1280 tokens)
VL_IMAGES = {"img448": (448, 448), "img448b": (448, 448), "imgmax": (1120, 896)}
VL_DEPTH_CUT = 4  # LM layers of the float32 and bf16-against-float32 runs
VL_TOWER_CHECK_LAYERS = 2  # tower layers of the card-against-CPU check
VL_NEW = 32  # new tokens of every phase-12 request
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
# the tower in float32 on the card against the CPU: the same arithmetic
# summed in another order (TF32 off), over up to 5120 keys and 32 layers
VL_TOWER_RTOL, VL_TOWER_ATOL = 1e-4, 1e-4


def vl_image(name: str):
    import numpy as np

    h, w = VL_IMAGES[name]
    return np.random.default_rng(sorted(VL_IMAGES).index(name) + 12).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


def png_bytes(arr) -> bytes:
    """An RGB uint8 [H, W, 3] array as a PNG file (zlib and struct only)."""
    import struct
    import zlib

    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def vl_processed(dev) -> dict:
    """name -> the gateway's Qwen2-VL processing of each image, on the card."""
    from smg_tpu_torch.models.vit import MAX_PIXELS
    from smg_tpu_torch.multimodal.processor import Qwen2VLImageProcessor

    proc = Qwen2VLImageProcessor(device=dev)
    out = {n: proc.process(vl_image(n)) for n in VL_IMAGES}
    grids = {n: (p.grid, p.num_placeholder_tokens) for n, p in out.items()}
    want = {"img448": ((32, 32), 256), "img448b": ((32, 32), 256),
            "imgmax": ((80, 64), 1280)}
    if grids != want or 1120 * 896 != MAX_PIXELS:
        raise AssertionError(f"processed grids {grids} != {want}")
    return out


def vl_prompt(parts, embeds: dict, processed: dict):
    """(ids, mm_embeds) of ``parts``: token-id lists and image names (each
    its placeholder run of ``VL_IMAGE_TOKEN``)."""
    import numpy as np

    ids, rows, positions, grids = [], [], [], []
    for p in parts:
        if isinstance(p, str):
            n = processed[p].num_placeholder_tokens
            positions += range(len(ids), len(ids) + n)
            rows.append(embeds[p])
            grids.append(processed[p].llm_grid)
            ids += [VL_IMAGE_TOKEN] * n
        else:
            ids += list(p)
    if not rows:
        return ids, None
    return ids, (np.concatenate(rows), np.asarray(positions), grids)


def _vl_text(n: int, seed: int) -> list:
    import numpy as np

    return np.random.default_rng(seed).integers(1000, 120000, n).tolist()


def vl_requests(engine, processed: dict):
    """Phase 12's requests for ``drive_engine``, each image encoded by the
    engine's own tower: the 1280-token image (3 chunks of 512 through its
    run), a 256-token image, two images in one request, a text request; then,
    once ``img448`` finished, the same image behind the same ids (a prefix
    hit) and another image behind them (none: the first page holds image
    rows)."""
    embeds = {n: engine.encode_image(p.pixel_values, p.grid) for n, p in processed.items()}
    req = lambda *parts: vl_prompt(parts, embeds, processed)  # noqa: E731
    first = [("imgmax", *req(_vl_text(10, 1), "imgmax", _vl_text(20, 2))),
             ("img448", *req(_vl_text(4, 3), "img448", _vl_text(30, 4))),
             ("two", *req(_vl_text(8, 5), "img448", _vl_text(8, 6), "img448b", _vl_text(8, 7))),
             ("text", _vl_text(300, 8))]
    later = [("img448_same", *req(_vl_text(4, 3), "img448", _vl_text(30, 4))),
             ("img448_other", *req(_vl_text(4, 3), "img448b", _vl_text(30, 4)))]
    return first, later, "img448"


def vl_tower_work(vcfg, n: int) -> dict:
    """Operations of one ``forward_vision`` over ``n`` patches, by the type
    they run in: the products in the tower's dtype (bf16), the attention's
    two float32 products; and its weight bytes."""
    H, I, P, m2 = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_dim, vcfg.merge_size ** 2
    L, nh, d = vcfg.num_layers, vcfg.num_heads, vcfg.head_dim
    low = (2 * n * P * H + L * 2 * n * (3 * H * H + H * H + 2 * H * I)
           + 2 * (n // m2) * (m2 * H) * (m2 * H + vcfg.out_hidden_size))
    f32 = L * 2 * (2 * nh * n * n * d)
    weights = 2 * (P * H + L * (4 * H * H + 2 * H * I) + (m2 * H) * (m2 * H + vcfg.out_hidden_size))
    return dict(bf16_flops=low, f32_flops=f32, weight_bytes=weights,
                pixel_bytes=n * P * 4, out_bytes=(n // m2) * vcfg.out_hidden_size * 2)


def vl_tower(cfg, dev, card: str, processed: dict) -> dict:
    """(a) The tower: float32 at ``VL_TOWER_CHECK_LAYERS`` layers on the card
    against the CPU for both image sizes; bf16 at full depth timed for
    both against its operations bound, and its peak memory above the
    weights for the largest image against the planner's reserve."""
    import dataclasses

    import torch

    from smg_tpu_torch.models.vit import forward_vision, init_vision_params, vision_peak_bytes

    out = {}
    v32 = dataclasses.replace(cfg.vision, num_layers=VL_TOWER_CHECK_LAYERS, dtype="float32")
    p32 = init_vision_params(v32, torch.Generator(device=dev).manual_seed(5), dev)
    host = _map_tree(p32, lambda t: t.cpu())
    for name in ("img448", "imgmax"):
        p = processed[name]
        got = forward_vision(p32, v32, p.pixel_values, p.grid).cpu()
        t0 = time.perf_counter()
        want = forward_vision(host, v32, p.pixel_values.cpu(), p.grid)
        cpu_s = time.perf_counter() - t0
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= VL_TOWER_ATOL + VL_TOWER_RTOL * want.abs()).all())
        out[f"f32_{name}_max_abs_err"] = err
        print(f"  tower float32, {VL_TOWER_CHECK_LAYERS} layers, {name} {tuple(p.grid)}: card "
              f"against the CPU max_abs_err {err:.3e} (max |out| "
              f"{float(want.abs().max()):.3f}; CPU {cpu_s:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"the tower on the card disagrees with the CPU ({err:.3e})")
    del p32, host
    vcfg = cfg.vision
    tower = init_vision_params(vcfg, torch.Generator(device=dev).manual_seed(0 ^ 0x71510), dev)
    for name in ("img448", "imgmax"):
        p = processed[name]
        n = p.grid[0] * p.grid[1]
        run = lambda: forward_vision(tower, vcfg, p.pixel_values, p.grid)  # noqa: E731, B023
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        emb = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        if emb.shape != (n // 4, cfg.hidden_size) or not torch.isfinite(emb).all():
            raise AssertionError(f"tower output {tuple(emb.shape)} for {name}")
        del emb
        ms = cuda_ms(run, warmup=1, reps=5)
        w = vl_tower_work(vcfg, n)
        low_ms, f32_ms = w["bf16_flops"] / BF16_FLOPS * 1e3, w["f32_flops"] / F32_FLOPS * 1e3
        bytes_ms = (w["weight_bytes"] + w["pixel_bytes"] + w["out_bytes"]) / HBM_BYTES_PER_S * 1e3
        bound = max(low_ms + f32_ms, bytes_ms)
        reserve = vision_peak_bytes(vcfg, n)
        out[name] = dict(patches=n, tokens=n // 4, ms=ms, bound_ms=bound,
                         bound_bf16_ms=low_ms, bound_f32_ms=f32_ms, bytes_ms=bytes_ms,
                         peak_bytes=peak, reserve_bytes=reserve, **w)
        print(f"  [{card}] tower bf16, {vcfg.num_layers} layers, {name}: {n} patches -> "
              f"{n // 4} tokens in {ms:.3f} ms of device time; bound {bound:.3f} ms "
              f"(products {w['bf16_flops'] / 1e12:.3f} TFLOP at the bf16 peak: {low_ms:.3f} ms, "
              f"attention {w['f32_flops'] / 1e12:.3f} TFLOP at the float32 peak: {f32_ms:.3f} "
              f"ms; bytes {bytes_ms:.3f} ms), {bound / ms:.3f} of it; peak {peak} bytes "
              f"above the weights (planner's bound {reserve})")
        if peak > reserve:
            raise AssertionError(f"tower peak {peak} over the planner's reserve {reserve}")
    out["tower_params"] = tower
    return out


def vl_image_column(engine, processed: dict, label: str) -> dict:
    """Decode on 4 image lanes (each the 256-token image and text, 1000
    tokens, an M-RoPE offset): the megastep graph with offsets replayed
    alone with CUDA events (cold L2), beside phase 3's text-lane reading."""
    from smg_tpu_torch.protocols.sampling import SamplingParams

    runner = engine.runner
    embeds = {"img448": engine.encode_image(processed["img448"].pixel_values,
                                            processed["img448"].grid)}
    outs = {}
    engine.start()
    for i in range(4):
        ids, mm = vl_prompt([_vl_text(4, 40 + i), "img448", _vl_text(740, 50 + i)], embeds,
                            processed)
        outs[i] = []
        engine.submit(ids, SamplingParams(temperature=0.0, max_new_tokens=64, ignore_eos=True),
                      rid=f"imgcol{i}", on_output=outs[i].append, mm_embeds=mm)
    wait_for(lambda: all(o and o[-1].finished for o in outs.values())
             and not engine.has_work(), "image lanes")
    engine.stop()
    # the widest image-lane megastep the run captured, and the text-lane
    # graph of the same shape (phase 3's profile captured it)
    steps = [s for s in runner.graphs.steps.values()
             if s.graph is not None and not s.use_pen and not s.use_lora]
    image = [s for s in steps if s.use_mrope]
    if not image:
        raise AssertionError(f"[{label}] no captured megastep with M-RoPE offsets: "
                             f"{sorted(runner.graphs.steps)}")
    img = max(image, key=lambda s: (s.K, s.mp))
    text = [s for s in steps if not s.use_mrope and (s.B, s.K) == (img.B, img.K)]
    out = {}
    for kind, s in (("image", img), ("text", max(text, key=lambda s: s.mp) if text else None)):
        if s is not None:
            out[kind] = dict(B=s.B, K=s.K, mp=s.mp,
                             replay_ms_per_column=cuda_ms(s.graph.replay) / s.K)
    print(f"  [{label}] decode column on 4 lanes, one graph replay alone: " + ", ".join(
        f"{k} lanes {v['replay_ms_per_column']:.3f} ms (K {v['K']}, mp {v['mp']})"
        for k, v in out.items()))
    return out


def vl_ttft(engine, processed: dict, label: str) -> dict:
    """The 1280-token image request alone, prefix cache flushed: host ms of
    its encode (synchronised) and from its submit to its first token."""
    import torch

    from smg_tpu_torch.protocols.sampling import SamplingParams

    p = processed["imgmax"]
    engine.flush_cache()
    engine.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = engine.encode_image(p.pixel_values, p.grid)  # fetched to the host
    enc_ms = (time.perf_counter() - t0) * 1e3
    ids, mm = vl_prompt([_vl_text(10, 1), "imgmax", _vl_text(20, 2)], {"imgmax": emb},
                        processed)
    got = []
    t1 = time.perf_counter()
    first = {}

    def on_output(o):
        if not got:
            first["t"] = time.perf_counter()
        got.append(o)

    engine.submit(ids, SamplingParams(temperature=0.0, max_new_tokens=2, ignore_eos=True),
                  rid="ttft", on_output=on_output, mm_embeds=mm)
    wait_for(lambda: got and got[-1].finished and not engine.has_work(), "ttft request")
    engine.stop()
    out = dict(prompt_tokens=len(ids), encode_ms=enc_ms, prefill_ms=(first["t"] - t1) * 1e3)
    out["ttft_ms"] = out["encode_ms"] + out["prefill_ms"]
    print(f"  [{label}] TTFT of the {len(ids)}-token image request alone: "
          f"{out['ttft_ms']:.2f} ms = encode {enc_ms:.2f} ms + submit to first token "
          f"{out['prefill_ms']:.2f} ms")
    return out


def vl_http(engine, processed: dict, tok, label: str) -> dict:
    """One image chat through the gateway ``serve`` runs (its context over
    this engine on a free local port), the image a PNG data URI: the reply's
    tokens equal the same pipeline driven directly (processor, encode, the
    placeholder expanded, ``submit``), each alone with the prefix cache
    flushed; then the same message through ``/v1/messages`` with the image
    as an Anthropic base64 ``source`` block gives the chat's text."""
    from smg_tpu_torch.gateway.launch import build_context
    from smg_tpu_torch.multimodal.image import decode_image
    from smg_tpu_torch.multimodal.ingest import expand_image_placeholders, flatten_content
    from smg_tpu_torch.multimodal.processor import processor_for_worker
    from smg_tpu_torch.protocols.sampling import SamplingParams

    png = png_bytes(vl_image("img448"))
    uri = "data:image/png;base64," + base64.b64encode(png).decode()
    text_a, text_b = _words(_vl_text(6, 60)), _words(_vl_text(6, 61))
    messages = [{"role": "user", "content": [
        {"type": "text", "text": text_a}, {"type": "image_url", "image_url": {"url": uri}},
        {"type": "text", "text": text_b}]}]
    # the direct pipeline
    model_id = engine.config.model_id
    vcfg = engine.config.model.vision
    proc = processor_for_worker(model_id, vcfg.patch_size, vcfg.merge_size,
                                device=engine.runner.device)
    p = proc.process(decode_image(png))
    emb = engine.encode_image(p.pixel_values, p.grid)
    flat = flatten_content(messages, tok.decode([VL_IMAGE_TOKEN], skip_special_tokens=False))
    ids = tok.encode(tok.apply_chat_template(flat, add_generation_prompt=True))
    ids, positions = expand_image_placeholders(ids, VL_IMAGE_TOKEN, [p.num_placeholder_tokens])
    engine.flush_cache()
    engine.start()
    got = []
    engine.submit(ids, SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True),
                  rid="direct", on_output=got.append,
                  mm_embeds=(emb, positions, [p.llm_grid]))
    wait_for(lambda: got and got[-1].finished and not engine.has_work(), "direct image chat")
    engine.stop()
    direct = [t for o in got for t in o.new_token_ids]
    engine.flush_cache()
    ctx = build_context(engine, policy="cache_aware", drain_timeout_secs=5)
    with _gateway_thread(ctx) as port:
        t0 = time.perf_counter()
        status, body = _http(port, "POST", "/v1/chat/completions", {
            "model": model_id, "messages": messages, "max_tokens": 8, "temperature": 0,
            "ignore_eos": True})
        http_ms = (time.perf_counter() - t0) * 1e3
        # the same message through /v1/messages, the image an Anthropic
        # base64 source block, from a cold prefix cache as the chat ran
        anth = [{"role": "user", "content": [
            {"type": "text", "text": text_a},
            {"type": "image", "source": {"type": "base64", "media_type": "image/png",
                                         "data": base64.b64encode(png).decode()}},
            {"type": "text", "text": text_b}]}]
        _http(port, "POST", "/flush_cache")
        m_status, m_body = _http(port, "POST", "/v1/messages", {
            "model": model_id, "messages": anth, "max_tokens": 8, "temperature": 0})
    ctx.registry.remove("inproc-0")
    if status != 200:
        raise AssertionError(f"[{label}] image chat over HTTP: {status} {body}")
    reply = [int(w[1:]) for w in body["choices"][0]["message"]["content"].split()]
    usage = body["usage"]
    print(f"  [{label}] image chat over HTTP (a {len(png)}-byte PNG, {p.grid} patches): "
          f"{status} in {http_ms:.1f} ms, prompt {usage['prompt_tokens']} tokens, "
          f"completion {usage['completion_tokens']}; tokens equal the direct pipeline's: "
          f"{reply == direct}")
    if reply != direct or usage["prompt_tokens"] != len(ids):
        raise AssertionError(f"[{label}] HTTP image chat {reply} ({usage}) != direct {direct} "
                             f"({len(ids)} prompt tokens)")
    m_body = m_body if isinstance(m_body, dict) else {"error": m_body}
    m_text = "".join(b.get("text") or "" for b in m_body.get("content", [])
                     if b.get("type") == "text") if m_status == 200 else None
    print(f"  [{label}] the same image message through /v1/messages (a base64 source block): "
          f"{m_status}, stop {m_body.get('stop_reason')}, text equal to the chat's: "
          f"{m_text == body['choices'][0]['message']['content']}")
    if (m_status != 200 or m_text != body["choices"][0]["message"]["content"]
            or m_body["stop_reason"] != "max_tokens"
            or m_body["usage"]["input_tokens"] != usage["prompt_tokens"]):
        raise AssertionError(f"[{label}] /v1/messages image: {m_status} {m_body} != chat {body}")
    return dict(status=status, http_ms=http_ms, png_bytes=len(png), prompt_tokens=len(ids),
                tokens_equal=True, messages_text_equal=True)


# phase 12 (d): the nine other image families, video and the families' chats
# (height, width) of the seeded RGB images every processor runs on, card
# against CPU: InternVL's area gate and Llama 4's ties, Kimi-K2.5's padding
# (none of the three is a multiple of 28), Pixtral's cap at its edge
BREADTH_IMAGES = {"landscape": (768, 1024), "tall": (900, 200), "tiny": (64, 64)}
# one model name of each family the gateway keys a processor by
BREADTH_MODELS = {
    "qwen2_vl": "Qwen/Qwen2-VL-7B-Instruct", "llava": "llava-hf/llava-1.5-7b-hf",
    "internvl": "OpenGVLab/InternVL2-8B", "pixtral": "mistralai/Pixtral-12B-2409",
    "gemma3": "google/gemma-3-12b-it", "phi3_v": "microsoft/Phi-3.5-vision-instruct",
    "llama4": "meta-llama/Llama-4-Scout-17B-16E-Instruct",
    "phi4_v": "microsoft/Phi-4-multimodal-instruct", "kimi_k25": "moonshotai/Kimi-K2.5",
    "qwen3_omni": "Qwen/Qwen3-Omni-30B-A3B-Instruct",
}
# families whose placeholder run is the 2x2-merging tower's rows (200), and
# those giving one placeholder a patch, whose encode the reference gateway
# answers with its 502.  Phi-4's count adds 17 + 16 x rows separators the
# tower does not return (a 502 in both gateways, tests/
# test_torch_multimodal_breadth.py); its fewest views are 27 x 1024 patches,
# five times the tower's planned reserve, so its chat runs only on the CPU.
BREADTH_OK = ("internvl", "gemma3", "phi3_v", "kimi_k25", "qwen3_omni")
BREADTH_502 = ("llava", "pixtral", "llama4")
BREADTH_NEW = 8  # new tokens of every family chat
# the processors' pixels on the card against the CPU, in units of the 0-255
# input over the processor's smallest std: float32 resize products summed in
# another order (TF32 off), as test_torch_vision holds the CPU to the reference
BREADTH_PIXEL_ATOL = 1e-3
VIDEO_FRAMES = 8


def _gif_bytes(n: int, h: int, w: int, seed: int) -> bytes:
    """``n`` seeded RGB frames as an animated GIF (PIL)."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    frames = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for _ in range(n)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=40)
    return buf.getvalue()


def _pixel_std(proc) -> float:
    from smg_tpu_torch.multimodal.image import DEFAULT_STD

    return 0.5 if proc.name in ("llama4", "phi4_v", "kimi_k25") else min(DEFAULT_STD)


def _same_processed(label: str, got, want, proc, dev) -> float:
    """The processing on ``dev`` against the CPU's: geometry exact, pixels
    within ``BREADTH_PIXEL_ATOL``; the largest pixel error."""
    import torch

    geo = lambda p: (tuple(p.grid), p.num_placeholder_tokens,  # noqa: E731
                     None if p.llm_grid is None else tuple(p.llm_grid))
    if geo(got) != geo(want) or got.pixel_values.device.type != dev.type:
        raise AssertionError(f"[{label}] card {geo(got)} on {got.pixel_values.device} != CPU "
                             f"{geo(want)}")
    err = float((got.pixel_values.cpu() - want.pixel_values).abs().max())
    if not err <= BREADTH_PIXEL_ATOL / 255.0 / _pixel_std(proc) or \
            not torch.isfinite(got.pixel_values).all():
        raise AssertionError(f"[{label}] pixels {err:.3e} off the CPU's")
    return err


@contextlib.contextmanager
def _gateway_thread(ctx, name: str = "gateway"):
    """``ctx`` served on a free local port by a thread of its own; yields the
    port and stops the gateway on exit."""
    import asyncio
    import threading

    from smg_tpu_torch.gateway.launch import serve_context

    port = _free_port()
    held = {}

    async def serve():
        held["loop"], held["stop"] = asyncio.get_running_loop(), asyncio.Event()
        await serve_context(ctx, "127.0.0.1", port, held["stop"])

    server = threading.Thread(target=lambda: asyncio.run(serve()), name=name)
    server.start()
    try:
        wait_for(lambda: "stop" in held or not server.is_alive(), f"{name} start", timeout=60)
        deadline = time.monotonic() + 60
        while True:
            try:
                if _http(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                if time.monotonic() > deadline or not server.is_alive():
                    raise
            time.sleep(0.05)
        yield port
    finally:
        if "stop" in held:
            held["loop"].call_soon_threadsafe(held["stop"].set)
        server.join(LOOP_WAIT_S)
    if server.is_alive():
        raise AssertionError(f"the {name} did not shut down")


def vl_breadth(engine, tok, label: str, card: str) -> dict:
    """Phase 12 (d) on phase 12's engine: (1) each of the ten image
    processors (the gateway's geometry, patch 14 and merge 2 from the
    worker) on the card against the CPU over ``BREADTH_IMAGES``; (2) one
    image chat per ``BREADTH_OK`` family through the port's gateway with the
    engine registered under that family's model name: 200, the encode's
    rows equal to the placeholders, ``prompt_tokens`` the text's plus the
    placeholders, streamed (TTFT; encode ms read on the engine); (3) the
    ``BREADTH_502`` names: the reference's 502 text; (4) ``VideoProcessor``
    over an 8-frame GIF on the card against the CPU.  The kernels' launches
    of (2) and (3) are counted."""
    import numpy as np
    import torch

    from smg_tpu_torch.gateway.server import AppContext
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.gateway.workers import Worker
    from smg_tpu_torch.multimodal.ingest import flatten_content
    from smg_tpu_torch.multimodal.processor import processor_for_worker
    from smg_tpu_torch.multimodal.video import VideoProcessor
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    t0 = time.perf_counter()
    dev = engine.runner.device
    vcfg = engine.config.model.vision
    ps, ms = vcfg.patch_size, vcfg.merge_size
    out = {"processors": {}}
    print(f"phase 12 (d): the ten image processors on the card against the CPU, the "
          f"families' chats, video")
    imgs = {n: np.random.default_rng(70 + i).integers(0, 256, (*hw, 3), dtype=np.uint8)
            for i, (n, hw) in enumerate(BREADTH_IMAGES.items())}
    for family, model in BREADTH_MODELS.items():
        card_p = processor_for_worker(model, ps, ms, device=dev)
        cpu_p = processor_for_worker(model, ps, ms, device="cpu")
        if card_p.name != family:
            raise AssertionError(f"[{label}] {model} took the {card_p.name} processor")
        row = out["processors"][family] = {}
        for name, img in imgs.items():
            card_p.process(img)  # warm: the first call allocates
            torch.cuda.synchronize()
            ta = time.perf_counter()
            got = card_p.process(img)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - ta) * 1e3
            want = cpu_p.process(img)
            err = _same_processed(f"{label}/{family}/{name}", got, want, card_p, dev)
            row[name] = dict(grid=list(got.grid), tokens=got.num_placeholder_tokens,
                             card_ms=card_ms, max_abs_err=err)
        print(f"  [{card}] {family:10s} card ms " + ", ".join(
            f"{n} {tuple(BREADTH_IMAGES[n])} {r['card_ms']:.2f} ({r['tokens']} tokens, "
            f"err {r['max_abs_err']:.1e})" for n, r in row.items()))
    # the families' chats: one worker a family name, all on this engine
    png = png_bytes(vl_image("img448"))
    uri = "data:image/png;base64," + base64.b64encode(png).decode()
    image = vl_image("img448")
    text_a, text_b = _words(_vl_text(6, 80)), _words(_vl_text(6, 81))
    messages = [{"role": "user", "content": [
        {"type": "text", "text": text_a}, {"type": "image_url", "image_url": {"url": uri}},
        {"type": "text", "text": text_b}]}]
    placeholder = tok.decode([VL_IMAGE_TOKEN], skip_special_tokens=False)
    text_ids = tok.encode(tok.apply_chat_template(flatten_content(messages, placeholder),
                                                  add_generation_prompt=True))
    ctx = AppContext(policy="round_robin")
    clients = []
    for family in BREADTH_OK + BREADTH_502:
        clients.append(InProcWorkerClient(engine))
        ctx.tokenizers.register(BREADTH_MODELS[family], tok)
        ctx.registry.add(Worker(worker_id=f"family-{family}", client=clients[-1],
                                model_id=BREADTH_MODELS[family], page_size=PS))
    encodes = []
    encode = engine.encode_image

    def timed_encode(pixel_values, grid):
        ta = time.perf_counter()
        emb = encode(pixel_values, grid)  # ends in the blocking fetch
        encodes.append(dict(ms=(time.perf_counter() - ta) * 1e3, rows=int(emb.shape[0])))
        return emb

    engine.encode_image = timed_encode
    chats = out["chats"] = {}
    try:
        with _gateway_thread(ctx, "breadth-gateway") as port:
            dk.launches = 0
            pk.launches = 0
            for family in BREADTH_OK + BREADTH_502:
                model = BREADTH_MODELS[family]
                proc = processor_for_worker(model, ps, ms, device="cpu")
                p = proc.process(image)
                rows = p.grid[0] * p.grid[1] // (ms * ms)
                encodes.clear()
                _http(port, "POST", "/flush_cache")
                body = {"model": model, "messages": messages, "max_tokens": BREADTH_NEW,
                        "temperature": 0, "ignore_eos": True}
                if family in BREADTH_OK:
                    # the first chat (its shapes' first graph captures
                    # included) is checked; the same chat again, streamed,
                    # is timed
                    ta = time.perf_counter()
                    st, resp = _http(port, "POST", "/v1/chat/completions", body)
                    first_ms = (time.perf_counter() - ta) * 1e3
                    usage = resp.get("usage") or {} if isinstance(resp, dict) else {}
                    want_prompt = len(text_ids) - 1 + p.num_placeholder_tokens
                    chats[family] = r = dict(
                        status=st, placeholders=p.num_placeholder_tokens,
                        encode_rows=[e["rows"] for e in encodes], first_ms=first_ms,
                        prompt_tokens=usage.get("prompt_tokens"))
                    if (st != 200 or r["encode_rows"] != [p.num_placeholder_tokens]
                            or r["prompt_tokens"] != want_prompt
                            or usage.get("completion_tokens") != BREADTH_NEW):
                        raise AssertionError(f"[{label}/{family}] chat {r} {resp}, prompt "
                                             f"tokens wanted {want_prompt}")
                    encodes.clear()
                    _http(port, "POST", "/flush_cache")
                    st, frames = _sse(port, "/v1/chat/completions", {**body, "stream": True})
                    text, finish, _ = _sse_text(frames)
                    r.update(encode_ms=encodes[0]["ms"] if encodes else None,
                             ttft_ms=_first_content(frames) * 1e3 if st == 200 else None)
                    if st != 200 or text != resp["choices"][0]["message"]["content"]:
                        raise AssertionError(f"[{label}/{family}] the streamed chat: {st}, "
                                             f"{text!r} != {resp['choices'][0]['message']}")
                    print(f"  [{card}] {family} chat ({model}): 200, {p.num_placeholder_tokens} "
                          f"placeholders = the encode's rows, prompt {r['prompt_tokens']} "
                          f"tokens; streamed again: encode {r['encode_ms']:.2f} ms, TTFT "
                          f"{r['ttft_ms']:.2f} ms (the first chat {first_ms:.2f} ms whole)")
                else:
                    st, resp = _http(port, "POST", "/v1/chat/completions", body)
                    msg = (resp.get("error") or {}).get("message") if isinstance(resp, dict) \
                        else resp
                    want = (f"encode returned {rows} embeddings for "
                            f"{p.num_placeholder_tokens} placeholder tokens")
                    chats[family] = dict(status=st, message=msg)
                    if st != 502 or msg != want:
                        raise AssertionError(f"[{label}/{family}] {st} {resp}; wanted the "
                                             f"reference's 502 {want!r}")
                    print(f"  [{card}] {family} chat ({model}): 502 \"{msg}\"")
            out["launches"] = {"decode_attention": dk.launches,
                               "prefill_attention": pk.launches}
            # out of the registry before the gateway stops: its shutdown
            # would close the clients, and a closed client drains the engine
            for family in BREADTH_OK + BREADTH_502:
                ctx.registry.remove(f"family-{family}")
    finally:
        del engine.encode_image
        for c in clients:
            c._calls.shutdown(wait=False)
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"[{label}] the family chats launched {out['launches']}")
    # video: an 8-frame GIF through the Qwen2-VL processor, card against CPU
    gif = _gif_bytes(VIDEO_FRAMES, 224, 336, seed=90)
    vp_card = VideoProcessor(processor_for_worker("qwen2-vl", ps, ms, device=dev),
                             num_frames=VIDEO_FRAMES)
    vp_cpu = VideoProcessor(processor_for_worker("qwen2-vl", ps, ms, device="cpu"),
                            num_frames=VIDEO_FRAMES)
    torch.cuda.synchronize()
    ta = time.perf_counter()
    got = vp_card.process_bytes(gif)
    torch.cuda.synchronize()
    video_ms = (time.perf_counter() - ta) * 1e3
    want = vp_cpu.process_bytes(gif)
    err = float((got.pixel_values.cpu() - want.pixel_values).abs().max())
    if ((got.num_frames, got.frame_grids, got.num_placeholder_tokens)
            != (want.num_frames, want.frame_grids, want.num_placeholder_tokens)
            or got.num_frames != VIDEO_FRAMES or got.pixel_values.device.type != dev.type
            or not err <= BREADTH_PIXEL_ATOL / 255.0 / _pixel_std(vp_card.image_processor)):
        raise AssertionError(f"[{label}] video on the card {got.frame_grids} "
                             f"{got.num_placeholder_tokens} ({err:.3e}) != CPU")
    out["video"] = dict(frames=got.num_frames, tokens=got.num_placeholder_tokens,
                        card_ms=video_ms, max_abs_err=err)
    out["seconds"] = time.perf_counter() - t0
    print(f"  [{card}] video: {got.num_frames} GIF frames -> {got.num_placeholder_tokens} "
          f"tokens in {video_ms:.2f} ms on the card, pixels {err:.1e} off the CPU's; "
          f"launches {out['launches']}; phase 12 (d) took {out['seconds']:.1f} s")
    return out


def vl_sharing(runs, label: str) -> dict:
    """The same image behind the same ids shares KV; another image behind
    them shares none."""
    out = {}
    for name, r in runs.items():
        same, other = (r["results"][k].cached_tokens for k in ("img448_same", "img448_other"))
        out[name] = dict(same=same, other=other)
        if same <= 0 or other != 0:
            raise AssertionError(f"[{label}/{name}] prefix sharing: same image {same} cached, "
                                 f"another image {other}")
    print(f"  [{label}] cached tokens, the same image again / another image behind the same "
          f"ids: {out}")
    return out


def phase_vision(dev, card: str) -> dict:
    """Phase 12: Qwen2-VL-7B at full width (random bf16 weights from seed
    0, made on the card).  (a) the tower (``vl_tower``); (b) every request
    of ``vl_requests`` at full depth through the graph path (auto-sized KV,
    the vision reserve set aside), the decode profile, the image-lane
    column, the image TTFT and one image chat over HTTP; (c) the first
    ``VL_DEPTH_CUT`` layers through phase 3's three paths in float32 (the
    greedy streams identical, the text request equal to itself alone) and
    the graph and plain paths in bf16, held to the float32 run as phase 3
    holds them."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.engine.kv_cache import plan_cache, vision_reserve_bytes
    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.protocols.sampling import SamplingParams
    from smg_tpu_torch.tokenizer import MockTokenizer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  allocated before phase 12: {torch.cuda.memory_allocated(dev)} bytes")
    cfg = ModelConfig.from_hf_config(QWEN2_VL_7B, dtype="bfloat16")
    if (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.mrope_section,
            cfg.vision.hidden_size, cfg.vision.num_layers) != VL_SHAPE:
        raise AssertionError(f"Qwen2-VL-7B read as {cfg}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    lm_bytes = sum(t.numel() * t.element_size() for g in (params, params["layers"])
                   for k, t in g.items() if k != "layers")
    processed = vl_processed(dev)
    out = dict(card=card, lm_weight_bytes=lm_bytes, init_s=time.perf_counter() - t0)
    secs = out["seconds"] = {}
    print("phase 12 (a): the vision tower")
    t0 = time.perf_counter()
    tower_out = vl_tower(cfg, dev, card, processed)
    tower = tower_out.pop("tower_params")
    out["tower"] = tower_out
    tower_bytes = sum(t.numel() * t.element_size() for t in _tensors(tower))
    print(f"  [{card}] Qwen2-VL-7B: {lm_bytes} bytes of bf16 LM weights and {tower_bytes} of "
          f"tower weights")
    secs["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    print("phase 12 (b): full width and depth, bf16, the graph path")
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    L = cfg.num_layers
    sink = {}

    def readings(label, engine):
        runner = engine.runner
        spec, free = runner.spec, runner.free_bytes
        vres = vision_reserve_bytes(cfg)
        without = plan_cache(cfg, engine.config.cache, free,
                             reserve_bytes=runner.reserve_bytes - vres).num_pages
        sink["pages"] = dict(with_reserve=spec.num_pages, without_reserve=without,
                             vision_reserve_bytes=vres, free_bytes=free)
        print(f"  [{label}] auto-sized pages: {spec.num_pages} with the vision reserve of "
              f"{vres} bytes, {without} without it ({free} bytes free after the weights)")
        sink["column"] = vl_image_column(engine, processed, label)
        sink["ttft"] = vl_ttft(engine, processed, label)
        # before vl_http: its gateway's shutdown drains the engine
        sink["breadth"] = vl_breadth(engine, tok, label, card)
        sink["http"] = vl_http(engine, processed, tok, label)
        return {}

    runs = serve_paths(cfg, params, dev, VL_NEW, with_profile=True, auto_size=True,
                       paths=PATHS[:1], requests=lambda e: vl_requests(e, processed),
                       engine_kw=dict(tokenizer=tok, vision_params=tower), after=readings)
    out["agreement"] = check_runs(runs, L, VL_NEW, "vl bf16", hit="img448_same")
    out["sharing"] = vl_sharing(runs, "vl bf16")
    out["paths"] = summarize(runs, card, "vl bf16")
    out["launches"] = runs["graphs"]["launches"]
    out["schedule"] = runs["graphs"]["stats"]
    out["decode_profile_text"] = runs["graphs"]["profile"]
    out.update(sink)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    secs["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    print(f"phase 12 (c): the first {VL_DEPTH_CUT} layers, float32 and bf16")
    cut = dataclasses.replace(cfg, num_layers=VL_DEPTH_CUT)
    small = {k: v for k, v in params.items() if k != "layers"}
    small["layers"] = {k: v[:VL_DEPTH_CUT].clone() for k, v in params["layers"].items()}
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    runs16 = serve_paths(cut, small, dev, VL_NEW, paths=(PATHS[0], PATHS[2]),
                         requests=lambda e: vl_requests(e, processed),
                         engine_kw=dict(tokenizer=tok, vision_params=tower))
    check_runs(runs16, VL_DEPTH_CUT, VL_NEW, "vl bf16 cut", hit="img448_same")
    vl_sharing(runs16, "vl bf16 cut")
    _widen(small)
    tower32 = _map_tree(tower, lambda t: t.float())
    del tower
    cut32 = dataclasses.replace(cut, dtype="float32",
                                vision=dataclasses.replace(cut.vision, dtype="float32"))
    alone = {}

    def text_alone(label, engine):
        engine.flush_cache()
        alone[label] = engine.generate(prompt_ids=_vl_text(300, 8), sampling=SamplingParams(
            temperature=0.0, max_new_tokens=VL_NEW, ignore_eos=True)).token_ids
        return {}

    runs32 = serve_paths(cut32, small, dev, VL_NEW, requests=lambda e: vl_requests(e, processed),
                         engine_kw=dict(tokenizer=tok, vision_params=tower32), after=text_alone)
    agree32 = check_runs(runs32, VL_DEPTH_CUT, VL_NEW, "vl f32 cut", hit="img448_same")
    vl_sharing(runs32, "vl f32 cut")
    n = len(runs32["plain"]["results"])
    if agree32["streams_equal"] != {k: n for k in agree32["streams_equal"]} or \
            max(agree32["logit_gap"].values()) > F32_LOGIT_ATOL:
        raise AssertionError(f"vl f32 paths disagree: {agree32}")
    for label, ids in alone.items():
        if ids != runs32[label]["results"]["text"].token_ids:
            raise AssertionError(f"[vl f32 cut/{label}] the text request alone "
                                 f"{ids} != beside the images")
    print(f"  [vl f32 cut] the text request alone equals its stream beside the images on "
          f"every path: {sorted(alone)}")
    ref = runs32["plain"]["logits"]
    err = {name: max(float((a - b).abs().max()) for a, b in zip(runs16[name]["logits"], ref))
           for name in runs16}
    print(f"  [vl bf16 cut] first-token logits against the f32 run: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in err.items()))
    if not err["graphs"] <= BF16_ERR_RATIO * err["plain"]:
        raise AssertionError(f"vl bf16 kernel logits {err} from the f32 run, more than "
                             f"{BF16_ERR_RATIO} x the plain version's")
    out["depth_cut"] = dict(f32_agreement=agree32, bf16_logit_err_vs_f32=err,
                            f32=summarize(runs32, card, "vl f32 cut"),
                            launches_f32=runs32["graphs"]["launches"])
    del runs16, runs32, small, tower32
    gc.collect()
    torch.cuda.empty_cache()
    secs["c"] = time.perf_counter() - t0
    print(f"  phase 12 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _map_tree(tree, fn):
    """``fn`` over every tensor of a nested dict, in a new dict."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def threading_call(fn, result: dict):
    """Run ``fn`` on a thread of its own; its value lands in ``result``."""
    import threading

    def run():
        result["value"] = fn()

    t = threading.Thread(target=run)
    t.start()
    return t


PD_LAYERS = 4  # phase 13's float32 depth
PD_PAGES = 2048  # KV pages of each bf16 engine of phase 13: 4.29 GB at Llama-3-8B
PD_F32_PAGES = 1024  # KV pages of each 4-layer float32 engine: 0.54 GB
PD_GRPC_PAGES = 512  # KV pages of each gRPC worker process
PD_NEW = 32  # new tokens of the lone chats
PD_CONC_NEW = 16  # new tokens of each of the 8 concurrent chats
PD_REPS = 3  # TTFT repeats and host-handoff repeats (medians)
PD_WORKERS = ("prefill-0", "decode-0")


def _pd_jobs(seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    return dict(lone=ids(1400), warm=ids(1400),
                conc=[ids(int(n)) for n in rng.integers(100, 600, 8)])


def _pd_engine(cfg, params, dev, tok, pages: int, graphs: bool = True, overlap: bool = True):
    """An engine with phase 5's scheduler settings and ``pages`` KV pages
    sized by hand: two engines share one card, and auto-sizing would give
    the first one nearly all of it."""
    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine

    return Engine(EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=PS, num_pages=pages, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4, overlap_schedule=overlap),
        decode_graphs=graphs, model_id=SERVE_MODEL), params=params, device=dev, tokenizer=tok)


def _pd_context(clients, connector: str, tok):
    """A gateway built from ``serve --kv-connector connector`` with the two
    clients registered as the PREFILL and the DECODE worker, as
    ``tests/test_pd.py`` registers them."""
    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import gateway_options
    from smg_tpu_torch.gateway.server import AppContext
    from smg_tpu_torch.gateway.workers import Worker, WorkerType

    args = build_parser().parse_args(["serve", "--model-preset", SERVE_MODEL,
                                      "--kv-connector", connector])
    ctx = AppContext(**gateway_options(args))
    ctx.tokenizers.register(SERVE_MODEL, tok, default=True)
    for wid, wtype, client in zip(PD_WORKERS, (WorkerType.PREFILL, WorkerType.DECODE),
                                  clients):
        ctx.registry.add(Worker(worker_id=wid, client=client, model_id=SERVE_MODEL,
                                page_size=PS, worker_type=wtype))
    return ctx


def _prefilled(engine, prompt, export, sp, rid: str) -> tuple:
    """``submit_prefilled`` on ``engine``, stepped here when no loop thread
    runs; (tokens, logprobs)."""
    outs = []
    engine.submit_prefilled(prompt, export["first_token"], export["k"], export["v"], sp,
                            rid=rid, on_output=outs.append)
    if engine._thread is None:
        while not (outs and outs[-1].finished):
            engine.step()
    else:
        wait_for(lambda: outs and outs[-1].finished, f"PD decode of {rid}")
    return [t for o in outs for t in o.new_token_ids], [x for o in outs for x in o.logprobs]


def _chat_text(port: int, body: dict) -> tuple:
    st, resp = _http(port, "POST", "/v1/chat/completions", body)
    if st != 200:
        return st, None
    return st, resp["choices"][0]["message"]["content"]


def _spans(obj, name: str, when=None) -> tuple:
    """Wrap ``obj.name`` to record the (start, end) host times of its calls
    (those where ``when(*args)`` holds); returns (the list, an undo)."""
    spans = []
    orig = getattr(obj, name)

    def timed(*a, **kw):
        keep = when is None or when(*a, **kw)
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            if keep:
                spans.append((t0, time.perf_counter()))

    setattr(obj, name, timed)
    return spans, lambda: delattr(obj, name)


def _stop_gateways(held, server, contexts) -> None:
    held["loop"].call_soon_threadsafe(held["stop"].set)
    server.join(LOOP_WAIT_S)
    if server.is_alive():
        raise AssertionError("the gateways did not shut down")
    # aiohttp keeps finished apps, with their contexts: the workers go
    for ctx in contexts:
        for w in ctx.registry.list():
            ctx.registry.remove(w.worker_id)


def phase_pd(cfg, params, dev, card: str, phase3_decode_ms: float | None = None,
             worker_cli: dict | None = None) -> dict:
    """Phase 13, PD disaggregation on Llama-3-8B: (a) float32 at
    ``PD_LAYERS`` layers: a PREFILL and a DECODE engine behind the port's
    gateway (connectors ``auto`` and ``host``) against a co-located engine;
    (b) bf16 at full depth, the same engines on phase 3's weights, with the
    handoff, TTFT and decode readings; (c) the gRPC worker: two processes
    serving 4-layer float32 engines behind the gateway, and the ``worker``
    subcommand."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.tokenizer import MockTokenizer

    t_phase = time.perf_counter()
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    jobs = _pd_jobs(13)
    failures: list = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [pd] CHECK FAILED: {what}")

    out = {}
    cfg4 = dataclasses.replace(cfg, num_layers=PD_LAYERS, dtype="float32")
    p4 = {**{k: v.float() for k, v in params.items() if k != "layers"},
          "layers": {k: v[:PD_LAYERS].float() for k, v in params["layers"].items()}}
    out["f32"] = _pd_run(cfg4, p4, dev, tok, jobs, "f32", PD_F32_PAGES, expect)
    del p4
    gc.collect()
    torch.cuda.empty_cache()
    out["bf16"] = _pd_run(cfg, params, dev, tok, jobs, "bf16", PD_PAGES, expect,
                          phase3_decode_ms=phase3_decode_ms)
    out["launches"] = out["bf16"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    out["grpc"] = pd_grpc(cfg, dev, tok, jobs, out["f32"]["host_texts"], expect)
    # the worker CLI check, unless it ran beside the kernels' build (``main``:
    # the card is empty then, and its KV sizing takes nothing from a phase)
    out["worker_cli"] = worker_cli or check_worker_cli(dev.type)
    expect(out["worker_cli"]["health"] and out["worker_cli"]["exit_code"] == 0,
           f"worker subcommand: {out['worker_cli']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 13 took {out['seconds']:.1f} s ({card})")
    if failures:
        raise AssertionError(f"phase 13: {len(failures)} checks failed: {failures}")
    return out


def _pd_run(cfg, params, dev, tok, jobs, label: str, pages: int, expect,
            phase3_decode_ms: float | None = None) -> dict:
    """One dtype of phase 13 (a) or (b): engines P (prefill), D (decode,
    graphs), C (co-located) and, in float32, E (eager and synchronous)."""
    import gc

    import torch

    from smg_tpu_torch.gateway.launch import build_context
    from smg_tpu_torch.gateway.server import build_app
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    f32 = label == "f32"
    L = cfg.num_layers
    out = {}
    P = _pd_engine(cfg, params, dev, tok, pages)
    D = _pd_engine(cfg, params, dev, tok, pages)
    C = _pd_engine(cfg, params, dev, tok, pages)
    E = _pd_engine(cfg, params, dev, tok, pages, graphs=False, overlap=False) if f32 else None
    print(f"  [{label}] engines P, D, C{', E' if f32 else ''}: {L} layers, {pages} KV pages "
          f"each; memory allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    lone = _chat_ids(tok, jobs["lone"])
    sp = SamplingParams(temperature=0.0, max_new_tokens=PD_NEW, ignore_eos=True)
    # ---- engine-level: the legs, the payload, a graph captured before an import
    want = C.generate(lone, sp)
    C.flush_cache()
    warm = P.prefill_export(_chat_ids(tok, jobs["warm"]), sp, connector="device")
    _prefilled(D, _chat_ids(tok, jobs["warm"]), warm, sp, "warm")  # captures D's shapes
    graphs0 = D.runner.graphs.num_graphs
    legs = {}
    for connector in ("device", "host"):
        exp = P.prefill_export(lone, sp, connector=connector)
        where = {"device": P.runner.k_cache.device, "host": torch.device("cpu")}[connector]
        expect(exp["connector"] == connector and exp["k"].device == exp["v"].device == where,
               f"[{label}] {connector} payload on {exp['k'].device}, want {where}")
        expect(tuple(exp["k"].shape) == (L, math.ceil(len(lone) / PS), PS,
                                         cfg.num_kv_heads * cfg.head_dim),
               f"[{label}] payload shape {tuple(exp['k'].shape)}")
        toks, lps = _prefilled(D, lone, exp, sp, f"lone-{connector}")
        legs[connector] = toks
        expect(toks == want.token_ids, f"[{label}] PD over {connector}: tokens differ from "
                                       f"the co-located engine's")
        if f32:
            gap = max(abs(a - b) for a, b in zip(lps[1:], want.logprobs[1:]))
            expect(gap <= 1e-4, f"[{label}] PD over {connector}: logprobs {gap:.2e} from "
                                f"the co-located engine's")
            etoks, elps = _prefilled(E, lone, exp, sp, f"eager-{connector}")
            gap = max(abs(a - b) for a, b in zip(lps, elps))
            expect(etoks == toks and gap <= 1e-4,
                   f"[{label}] graph replay over imported pages vs eager: tokens "
                   f"{etoks == toks}, logprobs {gap:.2e}")
        expect(P.scheduler.pool.free_count == pages - 1,
               f"[{label}] prefill engine keeps {pages - 1 - P.scheduler.pool.free_count} pages")
    expect(D.runner.graphs.num_graphs == graphs0,
           f"[{label}] the decode engine captured {D.runner.graphs.num_graphs - graphs0} "
           "graphs for the imported lanes (want replays of graphs captured before)")
    hand = dict(D.runner.kv_handoffs)
    expect(hand["import_device"] == 2 and hand["import_host"] == 1,  # warm, device | host
           f"[{label}] decode engine imports {hand}")
    out["engine_level"] = dict(tokens_equal={k: v == want.token_ids for k, v in legs.items()},
                               handoffs={"P": dict(P.runner.kv_handoffs), "D": hand},
                               graphs_before_import=graphs0)
    if not f32:
        out["handoff"] = pd_handoff_readings(P, D, len(lone), cfg)
    # ---- through the gateway: PD on both connectors, and co-located
    ctxs = {c: _pd_context([InProcWorkerClient(P), InProcWorkerClient(D)], c, tok)
            for c in ("auto", "host")}
    ctxs["colocated"] = build_context(C, policy="cache_aware")
    ports = {name: _free_port() for name in ctxs}
    held, server = _serve_apps([(build_app(ctx), ports[name]) for name, ctx in ctxs.items()])
    try:
        texts = {}
        st, texts["colocated"] = _chat_text(ports["colocated"], _chat(jobs["lone"], PD_NEW))
        C.flush_cache()
        quiet = lambda: not (P.has_work() or D.has_work())  # noqa: E731
        wait_for(quiet, "PD engines idle")
        torch.cuda.synchronize()
        d_prefill = D.scheduler.num_prefill_tokens
        h0 = dict(D.runner.kv_handoffs)
        stats0 = {n: dict(e.runner.stats) for n, e in (("P", P), ("D", D))}
        dk.launches = pk.launches = 0  # the PD path's run starts here
        for c in ("auto", "host"):
            st, texts[c] = _chat_text(ports[c], _chat(jobs["lone"], PD_NEW))
            expect(st == 200 and texts[c] == texts["colocated"],
                   f"[{label}] lone chat over {c}: {st}, equal {texts[c] == texts['colocated']}")
        wait_for(quiet, "PD engines idle")
        torch.cuda.synchronize()
        launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        sched = {n: {k: e.runner.stats[k] - stats0[n][k] for k in stats0[n]}
                 for n, e in (("P", P), ("D", D))}
        want_l = {"decode_attention": L * sched["D"]["decode_columns"],
                  "prefill_attention": L * sched["P"]["prefill_calls"]}
        print(f"  [{label}] PD path launches {launches}, schedule P {sched['P']}, "
              f"D {sched['D']}")
        expect(launches == want_l and min(launches.values()) > 0,
               f"[{label}] PD launches {launches} != {want_l}")
        expect(sched["D"]["prefill_calls"] == 0 and sched["P"]["decode_calls"] == 0,
               f"[{label}] legs crossed: {sched}")
        out["launches"], out["schedule"] = launches, sched
        h1 = {k: D.runner.kv_handoffs[k] - h0[k] for k in h0}
        expect(h1["import_device"] == 1 and h1["import_host"] == 1,
               f"[{label}] gateway imports {h1}: auto must stay on the card")
        # eight concurrent chats per connector: D captures the new batch
        # shapes while P exports, both loop threads live
        conc = [_chat(p, PD_CONC_NEW) for p in jobs["conc"]]
        ref_conc = _in_threads(lambda b: _chat_text(ports["colocated"], b), [(b,) for b in conc])
        caps, undo_caps = _spans(D.runner.graphs, "run",
                                 lambda step, body: step.graph is None
                                 and D.runner.graphs.use_graphs)
        exps, undo_exps = _spans(P, "prefill_export")
        try:
            runs = {c: _in_threads(lambda b, c=c: _chat_text(ports[c], b), [(b,) for b in conc])
                    for c in ("auto", "host")}
        finally:
            undo_caps()
            undo_exps()
        overlap = sum(any(a0 < b1 and b0 < a1 for b0, b1 in exps) for a0, a1 in caps)
        equal = {}
        for c, res in runs.items():
            # bf16 batches of other compositions round otherwise: counted,
            # held to the co-located streams in float32 only
            equal[c] = sum(r == w for r, w in zip(res, ref_conc))
            expect(all(r[0] == 200 for r in res) and (equal[c] == len(conc) or not f32),
                   f"[{label}] 8 concurrent over {c}: {[r[0] for r in res]}, "
                   f"{equal[c]}/{len(conc)} equal to co-located")
        out["concurrent"] = dict(captures=len(caps), captures_during_exports=overlap,
                                 exports=len(exps), equal_to_colocated=equal)
        print(f"  [{label}] concurrent: D captured {len(caps)} graphs, {overlap} of them "
              f"while P exported ({len(exps)} exports)")
        if f32:
            out["host_texts"] = dict(lone=texts["host"], conc=[r[1] for r in runs["host"]])
        else:
            out["ttft_ms"] = pd_ttft(ports, C, jobs["lone"])
            out["decode"] = profile_decode(
                D, loop=True, label=f"[{label}] decode engine, 4 adopted lanes",
                submit=lambda rid, prompt, sp4, cb: _adopt(P, D, prompt, sp4, rid, cb))
            dms = out["decode"]["device_ms_per_column"]
            print(f"  [{label}] decode engine: {dms:.3f} device ms a column on 4 adopted "
                  f"lanes (phase 3's engine: {phase3_decode_ms or 'not measured here'})")
        expect(D.scheduler.num_prefill_tokens == d_prefill == 0,
               f"[{label}] the decode engine prefilled {D.scheduler.num_prefill_tokens} tokens")
    finally:
        _stop_gateways(held, server, ctxs.values())
        for e in (P, D, C, E):
            if e is not None:
                e.stop(drain=True, timeout=30)
    for e, name in ((P, "P"), (D, "D"), (C, "C")):
        audit = e.audit()
        expect(audit["clean"], f"[{label}] {name} audit after the drain: {audit}")
    expect(P.scheduler.pool.free_count == pages - 1, f"[{label}] P's pages after the drain")
    out["d_num_prefill_tokens"] = D.scheduler.num_prefill_tokens
    del P, D, C, E
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _adopt(P, D, prompt, sp, rid, cb) -> None:
    """A lane on D through PD: exported by P (on the card), adopted by D."""
    exp = P.prefill_export(prompt, sp, connector="device")
    D.submit_prefilled(prompt, exp["first_token"], exp["k"], exp["v"], sp, rid=rid,
                       on_output=cb)


def pd_ttft(ports: dict, C, lone_ids) -> dict:
    """Median time to the first content frame of the lone chat (8 new
    tokens, streamed), through the co-located gateway (the prefix cache
    flushed before each) and the two PD gateways, in turns."""
    ttft = {name: [] for name in ports}
    for _rep in range(PD_REPS):
        for name, port in ports.items():
            if name == "colocated":
                C.flush_cache()
            st, frames = _sse(port, "/v1/chat/completions", _chat(lone_ids, 8, stream=True))
            first = next(t for t, f in frames if f != "[DONE]" and f["choices"]
                         and f["choices"][0]["delta"].get("content"))
            ttft[name].append(first * 1e3)
    med = {name: statistics.median(v) for name, v in ttft.items()}
    print(f"  [bf16] TTFT of the {len(lone_ids)}-word chat, median of {PD_REPS} (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    return dict(median=med, all=ttft)


def pd_handoff_readings(P, D, n_tokens: int, cfg) -> dict:
    """The handoff of an ``n_tokens`` prompt's pages, P's cache to D's:
    device export and import (CUDA events, cold L2), host export and
    import (wall time with the blocking copies), and the pinned copy rates
    the host bounds come from.  Bounds from bytes: each leg reads and
    writes the payload once in device memory; the host legs also cross
    PCIe once each way."""
    import torch

    n_pages = math.ceil(n_tokens / PS)
    p_pages = P.scheduler.pool.alloc(n_pages)
    d_pages = D.scheduler.pool.alloc(n_pages)
    try:
        k, v = P.runner.export_pages_device(p_pages)
        payload = 2 * k.numel() * k.element_size()
        dev_export = cuda_ms(lambda: P.runner.export_pages_device(p_pages))
        dev_import = cuda_ms(lambda: D.runner.import_pages_device(d_pages, k, v))

        def wall(fn) -> float:
            times = []
            for _ in range(PD_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        hk, hv = P.runner.export_pages(p_pages)
        host_export = wall(lambda: P.runner.export_pages(p_pages))
        host_import = wall(lambda: D.runner.import_pages(d_pages, hk, hv))
        pinned = torch.empty(k.shape, dtype=k.dtype, pin_memory=k.is_cuda)
        d2h = cuda_ms(lambda: pinned.copy_(k, non_blocking=True))
        h2d = cuda_ms(lambda: k.copy_(pinned, non_blocking=True))
    finally:
        P.scheduler.release_pages(p_pages)
        D.scheduler.release_pages(d_pages)
    half = payload / 2  # K alone: one copy of each rate's measure
    d2h_rate, h2d_rate = half / (d2h * 1e-3), half / (h2d * 1e-3)
    leg = 2 * payload / HBM_BYTES_PER_S * 1e3  # read and write the payload once
    out = dict(
        tokens=n_tokens, pages=n_pages, payload_bytes=payload,
        device=dict(export_ms=dev_export, import_ms=dev_import, bound_ms_each=leg,
                    bound_ms=2 * leg),
        host=dict(export_ms=host_export, import_ms=host_import,
                  export_bound_ms=leg / 2 + payload / d2h_rate * 1e3,
                  import_bound_ms=leg / 2 + payload / h2d_rate * 1e3),
        pinned_rates_gb_s=dict(d2h=d2h_rate / 1e9, h2d=h2d_rate / 1e9))
    print(f"  [bf16] handoff of {n_tokens} tokens ({n_pages} pages, {payload} bytes of K and "
          f"V): device export {dev_export:.3f} ms + import {dev_import:.3f} ms (bound "
          f"{leg:.3f} ms each, bytes); host export {host_export:.2f} ms + import "
          f"{host_import:.2f} ms (bounds {out['host']['export_bound_ms']:.2f} and "
          f"{out['host']['import_bound_ms']:.2f} ms at the measured pinned rates "
          f"D2H {d2h_rate / 1e9:.1f} and H2D {h2d_rate / 1e9:.1f} GB/s)")
    return out


def pd_worker_main(spec: dict) -> int:
    """One gRPC worker of phase 13 (c) or 14 (c), in a process of its own:
    phase 3's weights made from the seed, cut to ``spec["layers"]`` layers
    and widened to float32, ``spec["pages"]`` KV pages, served with
    ``rpc.server.serve_worker`` until SIGTERM; then, given
    ``spec["report"]``, its kernel launches, the runner's schedule counts
    and its KV transfer counts (offers made, served, pulled, reclaimed,
    still pending) written there as JSON."""
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.ops.cuda import build
    from smg_tpu_torch.rpc.server import SchedulerServicer, serve_worker
    from smg_tpu_torch.tokenizer import MockTokenizer

    dev = torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        build.load()
    cfg = ModelConfig(**spec["config"])
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = spec["layers"]
    params = {**{k: v.float() for k, v in full.items() if k != "layers"},
              "layers": {k: v[:n].float() for k, v in full["layers"].items()}}
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, num_layers=n, dtype="float32")
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    engine = _pd_engine(cfg4, params, dev, tok, spec["pages"])
    engine.start()
    # the data_parallel_rank of every generate this worker receives
    ranks: dict = {}
    engine_for = SchedulerServicer._engine_for

    def recording(self, rank):
        ranks[str(rank)] = ranks.get(str(rank), 0) + 1
        return engine_for(self, rank)

    SchedulerServicer._engine_for = recording
    if spec.get("hold"):  # take the port only once this file exists
        hold, deadline = Path(spec["hold"]), time.monotonic() + LOOP_WAIT_S
        while not hold.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"{hold} did not appear in {LOOP_WAIT_S} s")
            time.sleep(0.02)
    code = serve_worker(engine, port=spec["port"], host="127.0.0.1")
    if spec.get("report"):  # this process's kernel launches, schedule and KV offers
        from smg_tpu_torch.ops.cuda import decode_attention, prefill_attention

        kv = getattr(engine.runner, "_kv_transfer", None)
        Path(spec["report"]).write_text(json.dumps(dict(
            launches={"decode_attention": decode_attention.launches,
                      "prefill_attention": prefill_attention.launches},
            stats=engine.runner.stats, layers=n, ranks=ranks,
            kv_transfer=None if kv is None else dict(
                kv.counts, pending=len(kv._offers), offers=len(kv.held())))))
    return code


def pd_grpc(cfg, dev, tok, jobs, host_texts: dict, expect) -> dict:
    """Phase 13 (c): two worker processes (``pd_worker_main``) behind two
    gateways as PREFILL and DECODE through ``GrpcWorkerClient``: one with
    ``auto``, which picks ``transfer`` (the decode worker pulls the KV from
    the prefill worker device to device, CUDA IPC), one with ``host``.  On
    both the lone chat and the 8 concurrent ones give the in-process host
    PD's texts.  This process pulls one offer of the lone prompt by
    (address, uuid) and holds it bitwise to a ``host`` export of the same
    prompt from the same worker.  Timed: the transfer and the host leg of
    the lone prompt (wall: export, then import to the first chunk) and the
    pull alone, each beside its bytes bound.  Each worker reports its
    transfer counts at exit: no offer left pending."""
    import asyncio
    import dataclasses
    import threading

    import torch
    from aiohttp import web

    from smg_tpu_torch.engine.kv_transfer import TransferManager
    from smg_tpu_torch.gateway.server import build_app
    from smg_tpu_torch.protocols.sampling import SamplingParams
    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    free = torch.cuda.mem_get_info(dev)[0]
    ports = [_free_port(), _free_port()]
    reports = [Path(tempfile.mkdtemp(prefix="smg_pd_grpc_")) / f"{i}.json" for i in range(2)]
    spec = dict(config=dataclasses.asdict(cfg), layers=PD_LAYERS, pages=PD_GRPC_PAGES,
                device=str(dev))
    children = []
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="pd-grpc-gateway")
    thread.start()

    def run(coro, timeout=LOOP_WAIT_S):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    held = {"runners": []}
    out = {"free_bytes_at_start": free}
    t0 = time.perf_counter()
    try:
        for i, port in enumerate(ports):
            children.append(Child(f"pd-worker-{i}", [
                sys.executable, REPO / "chip_smoke.py", "--pd-worker",
                json.dumps({**spec, "port": port, "report": str(reports[i])})]))

        async def up():
            held["clients"] = [GrpcWorkerClient(f"127.0.0.1:{p}") for p in ports]
            deadline = time.monotonic() + LOOP_WAIT_S
            for child, client in zip(children, held["clients"]):
                while not await client.health():
                    if not child.alive() or time.monotonic() > deadline:
                        raise AssertionError(f"a gRPC worker did not come up: {child.tail()}")
                    await asyncio.sleep(0.25)
            held["ports"] = {}
            for connector in ("auto", "host"):
                runner = web.AppRunner(build_app(_pd_context(held["clients"], connector, tok)))
                held["runners"].append(runner)
                await runner.setup()
                held["ports"][connector] = _free_port()
                await web.TCPSite(runner, "127.0.0.1", held["ports"][connector]).start()

        run(up())
        out["workers_up_s"] = time.perf_counter() - t0
        info = [run(c.get_model_info()) for c in held["clients"]]
        expect(all(i["supports_kv_transfer"] for i in info),
               f"[grpc] supports_kv_transfer {[i['supports_kv_transfer'] for i in info]}")
        conc = [_chat(p, PD_CONC_NEW) for p in jobs["conc"]]
        for connector, port in held["ports"].items():
            st, lone = _chat_text(port, _chat(jobs["lone"], PD_NEW))
            expect(st == 200 and lone == host_texts["lone"],
                   f"[grpc/{connector}] lone chat: {st}, equal to in-process host PD "
                   f"{lone == host_texts['lone']}")
            res = _in_threads(lambda b, port=port: _chat_text(port, b), [(b,) for b in conc])
            equal = sum(r == (200, w) for r, w in zip(res, host_texts["conc"]))
            expect(equal == len(res), f"[grpc/{connector}] 8 concurrent: {equal}/{len(res)} "
                                      "equal to the in-process host PD's")
        ids = _chat_ids(tok, jobs["lone"])
        sp = SamplingParams(temperature=0.0, max_new_tokens=2, ignore_eos=True)
        p_client, d_client = held["clients"]

        async def leg(connector: str) -> dict:
            """The legs alone, on the wall clock: the export, then the
            import up to the decode leg's first chunk."""
            from smg_tpu_torch.gateway.worker_client import WorkerGenerateRequest

            ta = time.perf_counter()
            exp = await p_client.prefill_export(ids, sp, connector=connector)
            tb = time.perf_counter()
            first = None
            async for _c in d_client.generate_prefilled(
                    WorkerGenerateRequest(rid=f"grpc-legs-{connector}", input_ids=ids,
                                          sampling=sp),
                    exp["first_token"], exp["k"], exp["v"]):
                if first is None:
                    first = time.perf_counter()
            if exp["connector"] == "transfer":
                await p_client.release_kv_offer(exp["k"]["transfer_uuid"], True)
            return dict(connector=exp["connector"], export_ms=(tb - ta) * 1e3,
                        import_to_first_chunk_ms=(first - tb) * 1e3,
                        leg_ms=(first - ta) * 1e3)

        out["legs"] = {c: [] for c in ("transfer", "host")}
        for _ in range(PD_REPS):  # in turns
            for c in ("transfer", "host"):
                out["legs"][c].append(run(leg(c)))
        expect([r["connector"] for r in out["legs"]["transfer"]] == ["transfer"] * PD_REPS,
               f"[grpc] transfer legs went by {[r['connector'] for r in out['legs']['transfer']]}")
        # this process pulls offers of the lone prompt by (address, uuid)
        puller = TransferManager(dev)
        pulls = []
        for _ in range(PD_REPS):
            exp = run(p_client.prefill_export(ids, sp, connector="transfer"))
            desc = exp["k"]
            torch.cuda.synchronize(dev)
            ta = time.perf_counter()
            k, v = puller.pull(desc["transfer_address"], desc["transfer_uuid"],
                               [(desc["kv_shape"], desc["kv_dtype"])] * 2)
            pulls.append((time.perf_counter() - ta) * 1e3)
            expect(run(p_client.release_kv_offer(desc["transfer_uuid"], True)),
                   "[grpc] ReleaseKvOffer of the pulled offer answered not ok")
        host = run(p_client.prefill_export(ids, sp, connector="host"))
        same = (k.device == dev and torch.equal(k.cpu(), host["k"])
                and torch.equal(v.cpu(), host["v"]))
        payload = 2 * k.numel() * k.element_size()
        expect(same and exp["first_token"] == host["first_token"],
               f"[grpc] the pulled offer ({k.device}, {tuple(k.shape)}) is not bitwise the "
               "host export of the same prompt")
        del k, v, host
        # bounds: the pull copies the payload once on the card (read +
        # write); the host leg copies it to the host and back at the
        # pinned rates measured here
        rates = _pinned_rates(dev, payload // 2)
        copy_bound = 2 * payload / HBM_BYTES_PER_S * 1e3
        host_bound = payload / rates["d2h"] * 1e3 + payload / rates["h2d"] * 1e3
        med = {c: {k: statistics.median(r[k] for r in rs) for k in rs[0] if k != "connector"}
               for c, rs in out["legs"].items()}
        out.update(legs_median=med, pull_ms=pulls, pull_median_ms=statistics.median(pulls),
                   pull_bound_ms=copy_bound, host_leg_bound_ms=host_bound,
                   payload_bytes=payload, pinned_rates_gb_s={k: r / 1e9 for k, r in rates.items()},
                   pulled_bitwise_equal_host=same)
        loads = run(d_client.get_loads())
        expect(loads["num_running"] == 0, f"[grpc] decode worker loads after: {loads}")
        print(f"  [grpc] 2 worker processes up in {out['workers_up_s']:.1f} s; lone and 8 "
              f"concurrent chats by transfer (auto) and host equal to in-process host PD; "
              f"the lone prompt ({payload} bytes of K and V, float32, {PD_LAYERS} layers), "
              f"wall medians of {PD_REPS}: transfer leg {med['transfer']['leg_ms']:.1f} ms "
              f"(export {med['transfer']['export_ms']:.1f} + import to first chunk "
              f"{med['transfer']['import_to_first_chunk_ms']:.1f}), host leg "
              f"{med['host']['leg_ms']:.1f} ms (export {med['host']['export_ms']:.1f} + "
              f"import to first chunk {med['host']['import_to_first_chunk_ms']:.1f}; its "
              f"copies bounded at {host_bound:.2f} ms by the pinned rates D2H "
              f"{rates['d2h'] / 1e9:.1f}, H2D {rates['h2d'] / 1e9:.1f} GB/s); this process's "
              f"pull {out['pull_median_ms']:.2f} ms (bound {copy_bound:.3f} ms, bytes), "
              f"bitwise the host export {same}")
    finally:
        async def down():
            for r in held["runners"]:
                await r.cleanup()
            for c in held.get("clients", []):
                await c.close()

        try:
            run(down(), timeout=60)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
            for child in children:
                child.terminate()
            out["exit_codes"] = [child.stop() for child in children]
    expect(out["exit_codes"] == [0, 0], f"[grpc] worker exit codes {out['exit_codes']}")
    reps = []
    for path in reports:
        reps.append(json.loads(path.read_text()) if path.exists() else {})
        shutil.rmtree(path.parent, ignore_errors=True)
    out["transfer_counts"] = [r.get("kv_transfer") for r in reps]
    p_kv, d_kv = out["transfer_counts"]
    # every transfer request of the gateway (9) and the legs: pulled by the
    # decode worker; this process's pulls served by the prefill worker too
    n_gateway = 1 + len(jobs["conc"])
    expect(p_kv is not None and p_kv["pending"] == 0 and p_kv["offers"] == 0
           and p_kv["served"] == n_gateway + 2 * PD_REPS and d_kv is not None
           and d_kv["pulled"] == n_gateway + PD_REPS and p_kv["reclaimed"] == 0,
           f"[grpc] transfer counts at exit: prefill {p_kv}, decode {d_kv}")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 13 (c) took {out['seconds']:.1f} s")
    # the kernels of both worker processes, counted over their lives
    names = ("decode_attention", "prefill_attention")
    out["launches"] = {k: sum(r.get("launches", {}).get(k, 0) for r in reps) for k in names}
    want = {"decode_attention": sum(PD_LAYERS * r["stats"]["decode_columns"]
                                    for r in reps if r),
            "prefill_attention": sum(PD_LAYERS * r["stats"]["prefill_calls"]
                                     for r in reps if r)}
    expect(out["launches"] == want and min(out["launches"].values()) > 0,
           f"[grpc] worker launches {out['launches']} != {want}")
    return out


def _pinned_rates(dev, nbytes: int) -> dict:
    """Device-to-host and host-to-device copy rates (bytes/s) of ``nbytes``
    between the card and pinned memory (``cuda_ms``, as phase 13 (b)'s)."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return {"d2h": nbytes / (cuda_ms(lambda: host.copy_(src, non_blocking=True)) * 1e-3),
            "h2d": nbytes / (cuda_ms(lambda: src.copy_(host, non_blocking=True)) * 1e-3)}


def check_worker_cli(device: str = "cuda") -> dict:
    """``python -m smg_tpu_torch.cli worker`` in a process of its own on the
    card (tiny preset, float32): ``HealthCheck`` answers, then SIGTERM."""
    import asyncio
    import signal

    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    port = _free_port()
    cmd = [sys.executable, "-m", "smg_tpu_torch.cli", "worker", "--model-preset", "tiny",
           "--dtype", "float32", "--max-seq-len", "1024", "--grpc-port", str(port),
           "--device", device]

    async def probe(proc):
        client = GrpcWorkerClient(f"127.0.0.1:{port}")
        try:
            deadline = time.monotonic() + LOOP_WAIT_S
            while proc.poll() is None and time.monotonic() < deadline:
                if await client.health():
                    return True, (await client.get_model_info())["model_id"]
                await asyncio.sleep(0.2)
            return False, None
        finally:
            await client.close()

    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=log)
        try:
            health, model = asyncio.run(probe(proc))
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        if not health:
            log.seek(0)
            print(log.read().decode()[-2000:])
    out = dict(health=health, model_id=model, exit_code=proc.returncode)
    print(f"  worker --model-preset tiny --device {device}: {out}")
    return out


LAUNCH_NEW = 32  # new tokens of the lone chats of phase 14
LAUNCH_CONC_NEW = 16  # new tokens of each of the 8 concurrent streams
LAUNCH_TTFT_NEW = 8  # new tokens of each timed stream
LAUNCH_REPS = 3  # timed repeats (medians), in turns
LAUNCH_DRAIN_NEW = 512  # new tokens of the stream a drain waits for
# phase 5's engine settings as serve and worker flags; the KV is auto-sized
LAUNCH_ENGINE = ("--max-batch-size", "8", "--max-seq-len", "4096", "--max-prefill-tokens",
                 "512", "--decode-horizon", "4")
CLI = (sys.executable, "-m", "smg_tpu_torch.cli")


class Child:
    """A process this script started, its output in a temporary file."""

    def __init__(self, name: str, cmd: list):
        self.name, self.cmd = name, [str(c) for c in cmd]
        self.log = tempfile.TemporaryFile()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, stdout=self.log, stderr=self.log)
        self.signalled = False

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self) -> None:
        """SIGTERM, once: the gateway's handler goes with its event loop, so
        a second SIGTERM landing while the process exits kills it (-15)."""
        import signal

        if self.alive() and not self.signalled:
            self.proc.send_signal(signal.SIGTERM)
            self.signalled = True

    def tail(self, n: int = 3000) -> str:
        self.log.seek(0)
        return self.log.read().decode(errors="replace")[-n:]

    def stop(self, timeout: float = 120) -> int:
        """SIGTERM (unless sent already), then the exit code (killed after
        ``timeout`` s)."""
        self.terminate()
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        if self.proc.returncode != 0:
            print(f"  [{self.name}] exit {self.proc.returncode}; its log ends:\n{self.tail()}")
        self.log.close()
        return self.proc.returncode


def _wait_http_up(port: int, child: Child | None, what: str, timeout: float = LOOP_WAIT_S
                  ) -> float:
    """Seconds until ``GET /health`` on ``port`` answers 200."""
    t0 = time.perf_counter()
    while True:
        try:
            if _http(port, "GET", "/health")[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if child is not None and not child.alive():
            raise AssertionError(f"{what} exited: {child.tail()}")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what} did not come up in {timeout} s")
        time.sleep(0.05)


def _grpc_up(port: int, child: Child, what: str, timeout: float = LOOP_WAIT_S) -> float:
    """Seconds from ``child``'s start until its gRPC ``HealthCheck`` answers."""
    import asyncio

    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    async def poll():
        # a channel per attempt: one channel would wait out gRPC's reconnect
        # backoff after each refused connection
        while True:
            client = GrpcWorkerClient(f"127.0.0.1:{port}")
            try:
                if await client.health():
                    return
            finally:
                await client.close()
            if not child.alive() or time.perf_counter() - child.t0 > timeout:
                raise AssertionError(f"{what} did not come up: {child.tail()}")
            await asyncio.sleep(0.1)

    asyncio.run(poll())
    return time.perf_counter() - child.t0


def _timed_in_thread(fn):
    """Start ``fn()`` on a thread; returns a function that joins it and
    gives its result (raising what it raised)."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn()
        except Exception as e:  # raised by the joining function
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()

    def result():
        t.join(LOOP_WAIT_S)
        if "error" in box:
            raise box["error"]
        return box["value"]

    return result


def _registration(port: int) -> dict:
    """The gateway's one ``worker_registration`` workflow, via /workflows."""
    st, body = _http(port, "GET", "/workflows?type=worker_registration")
    if st != 200 or len(body["workflows"]) != 1:
        raise AssertionError(f"/workflows: {st} {body}")
    return body["workflows"][0]


def _register_up(gw_port: int, gw: Child, worker_port: int, worker: Child, t_spawn: float,
                 what: str, expect, grpc: bool = True) -> dict:
    """Wait for a ``launch`` gateway that registers one worker at startup;
    when the worker came up after the registration's retry budget, resume
    the failed registration once the worker answers.  Returns the readings:
    seconds from the worker's spawn to its registration, the workflow."""
    _wait_http_up(gw_port, gw, what)
    up_s = time.perf_counter() - t_spawn
    wf = _registration(gw_port)
    resumed = False
    if wf["status"] != "completed":
        print(f"  [{what}] startup registration {wf['status']} ({wf['error']}); resuming "
              "once the worker answers")
        if grpc:
            _grpc_up(worker_port, worker, what)
        else:
            _wait_http_up(worker_port, worker, what)
        st, wf = _http(gw_port, "POST", f"/workflows/{wf['instance_id']}/resume")
        expect(st == 200, f"[{what}] resume: {st} {wf}")
        up_s, resumed = time.perf_counter() - t_spawn, True
    expect(wf["status"] == "completed" and wf["steps"]["tokenizer"]["status"] == "succeeded",
           f"[{what}] registration: {wf}")
    st2, one = _http(gw_port, "GET", f"/workflows/{wf['instance_id']}")
    expect(st2 == 200 and one["status"] == "completed", f"[{what}] /workflows/id: {one}")
    return dict(registered_s=up_s, resumed=resumed, workflow=wf,
                model_info_attempts=wf["steps"]["model_info"]["attempts"])


def _first_content(frames) -> float:
    return next(t for t, f in frames if f != "[DONE]" and f.get("choices")
                and (f["choices"][0].get("delta", {}).get("content")
                     or f["choices"][0].get("text")))


def _stream_timing(port: int, ids) -> tuple:
    """(TTFT ms, ms per token after the first) of the lone chat streamed
    with ``LAUNCH_NEW`` new tokens, the prefix cache flushed first."""
    _http(port, "POST", "/flush_cache")
    st, frames = _sse(port, "/v1/chat/completions", _chat(ids, LAUNCH_NEW, stream=True))
    if st != 200:
        raise AssertionError(f"a timed stream on port {port}: {st}")
    content = [t for t, f in frames if f != "[DONE]" and f.get("choices")
               and f["choices"][0]["delta"].get("content")]
    # ignore_eos: every stream has LAUNCH_NEW tokens
    return content[0] * 1e3, (content[-1] - content[0]) * 1e3 / (LAUNCH_NEW - 1)


def _gateway_readings(port: int, jobs: dict, label: str) -> dict:
    """The lone chat (not streamed and streamed, ``LAUNCH_NEW`` tokens), its
    TTFT and gap per token (medians of ``LAUNCH_REPS``), and the median
    TTFT of the 8 concurrent streams, through the gateway on ``port``."""
    _http(port, "POST", "/flush_cache")
    st, body = _http(port, "POST", "/v1/chat/completions", _chat(jobs["lone"], LAUNCH_NEW))
    if st != 200:
        raise AssertionError(f"[{label}] lone chat: {st} {body}")
    _http(port, "POST", "/flush_cache")
    st, frames = _sse(port, "/v1/chat/completions", _chat(
        jobs["lone"], LAUNCH_NEW, stream=True, stream_options={"include_usage": True}))
    text, finish, usage = _sse_text(frames)
    timed = [_stream_timing(port, jobs["lone"]) for _ in range(LAUNCH_REPS)]
    _http(port, "POST", "/flush_cache")
    conc = _in_threads(lambda b: _sse(port, "/v1/chat/completions", b),
                       [(_chat(p, LAUNCH_CONC_NEW, stream=True),) for p in jobs["conc"]])
    out = dict(text=body["choices"][0]["message"]["content"], usage=body["usage"],
               stream_text=text, stream_finish=finish, stream_usage=usage,
               ttft_ms=statistics.median(t for t, _g in timed),
               gap_ms_per_token=statistics.median(g for _t, g in timed),
               conc_ttft_ms=statistics.median(_first_content(f) * 1e3 for _s, f in conc),
               conc_texts=[_sse_text(f)[0] for _s, f in conc])
    print(f"  [{label}] lone chat TTFT {out['ttft_ms']:.2f} ms, {out['gap_ms_per_token']:.3f} "
          f"ms per token after it; 8 concurrent streams' median TTFT "
          f"{out['conc_ttft_ms']:.2f} ms (medians of {LAUNCH_REPS})")
    return out


def _serve_in_process(flags: list, dev) -> dict:
    """``serve``'s engine from ``flags``, behind the port's gateway in this
    process on a free port: {engine, ctx, port, held, thread}."""
    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import build_context, build_engine_from_args
    from smg_tpu_torch.gateway.server import build_app

    args = build_parser().parse_args(["serve", *flags, "--device", str(dev)])
    engine = build_engine_from_args(args)
    engine.start()
    ctx = build_context(engine, policy=args.policy)
    port = _free_port()
    held, thread = _serve_apps([(build_app(ctx), port)])
    return dict(engine=engine, ctx=ctx, port=port, held=held, thread=thread)


def _drop_in_process(inproc: dict, dev) -> None:
    """Stop what ``_serve_in_process`` started and give its memory back:
    the next process sizes its KV to what is free."""
    import gc

    import torch

    _stop_gateways(inproc.pop("held"), inproc.pop("thread"), [inproc["ctx"]])
    inproc.pop("engine").stop()
    inproc.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        print(f"  free after the in-process engine: {free} of {total} bytes "
              f"({torch.cuda.memory_allocated(dev)} still allocated here)")


def launch_grpc(preset: str, dev, card: str, jobs: dict, expect) -> dict:
    """Phase 14 (a): ``worker --model-preset`` at full width and depth behind
    ``launch --worker 127.0.0.1:P`` (no tokenizer flag: the gateway takes
    the worker's bundle), against ``serve``'s engine from the same flags in
    this process."""
    from smg_tpu_torch.tokenizer import MockTokenizer

    flags = ["--model-preset", preset, *LAUNCH_ENGINE]
    inproc = _serve_in_process(flags, dev)
    cfg = inproc["engine"].config.model
    try:
        ref = _gateway_readings(inproc["port"], jobs, "in-process serve")
    finally:
        _drop_in_process(inproc, dev)
    out = {"in_process": ref}
    wport, gport = _free_port(), _free_port()
    t_spawn = time.perf_counter()
    worker = Child("worker", [*CLI, "worker", *flags, "--device", str(dev),
                              "--grpc-port", wport])
    gw = Child("launch", [*CLI, "launch", "--host", "127.0.0.1", "--port", gport,
                          "--worker", f"127.0.0.1:{wport}"])
    up = _timed_in_thread(lambda: _grpc_up(wport, worker, "worker"))
    try:
        reg = _register_up(gport, gw, wport, worker, t_spawn, "launch/grpc", expect)
        out.update(reg, worker_up_s=up())
        st, workers = _http(gport, "GET", "/workers")
        expect(st == 200 and [(w["url"], w["model_id"]) for w in workers["workers"]]
               == [(f"127.0.0.1:{wport}", preset)], f"[launch/grpc] /workers: {workers}")
        want = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                             bos_token_id=cfg.bos_token_id).encode("w5 w99999",
                                                                  add_special_tokens=True)
        st, tokd = _http(gport, "POST", "/v1/tokenize", {"text": "w5 w99999",
                                                         "add_special_tokens": True})
        expect(tokd.get("tokens") == want,
               f"[launch/grpc] the gateway's ids {tokd} are not the worker's {want}")
        got = _gateway_readings(gport, jobs, "launch/grpc")
        out["launch"] = got
        for key in ("text", "usage", "stream_text", "stream_finish", "stream_usage"):
            expect(got[key] == ref[key], f"[launch/grpc] {key} differs from in-process serve")
        expect(got["text"] == got["stream_text"], "[launch/grpc] streamed text differs")
        print(f"  [launch/grpc] worker answered {out['worker_up_s']:.1f} s after its spawn, "
              f"registered after {reg['registered_s']:.1f} s (model_info attempts "
              f"{reg['model_info_attempts']}, resumed {reg['resumed']}); the lone chat's "
              f"tokens and text equal in-process serve's, streamed and not ({card})")
    finally:
        out["exit_codes"] = [gw.stop(), worker.stop()]
    expect(out["exit_codes"] == [0, 0], f"[launch/grpc] exit codes {out['exit_codes']}")
    return out


def _scrub_ids(obj):
    """A body or frame without its ids and times."""
    if isinstance(obj, dict):
        return {k: _scrub_ids(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_scrub_ids(v) for v in obj]
    return obj


def launch_http(preset: str, dev, card: str, jobs: dict, expect) -> dict:
    """Phase 14 (b): a ``serve`` process at full width and depth behind
    ``launch --worker http://127.0.0.1:S``: chat and completions, streamed
    and not, through ``launch`` give the bodies and SSE frames of the same
    requests sent straight to ``serve`` (ids and times removed; its prefix
    cache flushed before each); the TTFT the proxy hop adds."""
    sport, gport = _free_port(), _free_port()
    t_spawn = time.perf_counter()
    serve = Child("serve", [*CLI, "serve", "--model-preset", preset, *LAUNCH_ENGINE,
                            "--device", str(dev), "--host", "127.0.0.1", "--port", sport])
    gw = Child("launch", [*CLI, "launch", "--host", "127.0.0.1", "--port", gport,
                          "--worker", f"http://127.0.0.1:{sport}"])
    up = _timed_in_thread(lambda: _wait_http_up(sport, serve, "serve"))
    out = {}
    try:
        out.update(_register_up(gport, gw, sport, serve, t_spawn, "launch/http", expect,
                                grpc=False), serve_up_s=up())
        lone = jobs["lone"]
        requests = [("/v1/chat/completions", _chat(lone, LAUNCH_NEW)),
                    ("/v1/chat/completions", _chat(lone, LAUNCH_NEW, stream=True)),
                    ("/v1/completions", {"model": preset, "prompt": _words(lone),
                                         "max_tokens": LAUNCH_NEW, "temperature": 0,
                                         "ignore_eos": True}),
                    ("/v1/completions", {"model": preset, "prompt": _words(lone),
                                         "max_tokens": LAUNCH_NEW, "temperature": 0,
                                         "ignore_eos": True, "stream": True})]
        equal = []
        for path, body in requests:
            got = {}
            for name, port in (("direct", sport), ("launch", gport)):
                _http(sport, "POST", "/flush_cache")
                if body.get("stream"):
                    st, frames = _sse(port, path, body)
                    got[name] = (st, [f if f == "[DONE]" else _scrub_ids(f)
                                      for _t, f in frames])
                else:
                    st, resp = _http(port, "POST", path, body)
                    got[name] = (st, _scrub_ids(resp))
            same = got["direct"] == got["launch"] and got["direct"][0] == 200
            equal.append(same)
            expect(same, f"[launch/http] {path} stream={bool(body.get('stream'))}: "
                         f"{str(got['launch'])[:300]} != {str(got['direct'])[:300]}")
        ttft = {"direct": [], "launch": []}
        for _rep in range(LAUNCH_REPS):
            for name, port in (("direct", sport), ("launch", gport)):
                _http(sport, "POST", "/flush_cache")
                st, frames = _sse(port, "/v1/chat/completions",
                                  _chat(lone, LAUNCH_TTFT_NEW, stream=True))
                ttft[name].append(_first_content(frames) * 1e3)
        med = {k: statistics.median(v) for k, v in ttft.items()}
        out.update(bodies_equal=equal, ttft_ms=med, ttft_all=ttft,
                   proxy_added_ms=med["launch"] - med["direct"])
        print(f"  [launch/http] serve registered {out['registered_s']:.1f} s after its "
              f"spawn; {sum(equal)}/{len(equal)} bodies and frame lists equal to direct; "
              f"TTFT direct {med['direct']:.2f} ms, through launch {med['launch']:.2f} ms "
              f"(the proxy hop adds {out['proxy_added_ms']:.2f} ms; medians of "
              f"{LAUNCH_REPS}) ({card})")
    finally:
        out["exit_codes"] = [gw.stop(), serve.stop()]
    expect(out["exit_codes"] == [0, 0], f"[launch/http] exit codes {out['exit_codes']}")
    return out


def _pd_reference(cfg, params, dev, tok, jobs) -> dict:
    """The in-process PD of phase 13 (host connector) on ``params``: the
    lone and the 8 concurrent chats' texts through its gateway, and each
    prompt's PD legs driven directly (tokens, logprobs)."""
    from smg_tpu_torch.gateway.server import build_app
    from smg_tpu_torch.gateway.worker_client import InProcWorkerClient
    from smg_tpu_torch.protocols.sampling import SamplingParams

    P = _pd_engine(cfg, params, dev, tok, PD_GRPC_PAGES)
    D = _pd_engine(cfg, params, dev, tok, PD_GRPC_PAGES)
    P.start()
    D.start()
    ctx = _pd_context([InProcWorkerClient(P), InProcWorkerClient(D)], "host", tok)
    port = _free_port()
    held, thread = _serve_apps([(build_app(ctx), port)])
    try:
        st, lone = _chat_text(port, _chat(jobs["lone"], PD_NEW))
        conc = _in_threads(lambda b: _chat_text(port, b),
                           [(_chat(p, PD_CONC_NEW),) for p in jobs["conc"]])
        if st != 200 or any(s != 200 for s, _t in conc):
            raise AssertionError(f"in-process PD chats: {st}, {[s for s, _t in conc]}")
        legs = []
        for i, (prompt, n) in enumerate([(jobs["lone"], PD_NEW)]
                                        + [(p, PD_CONC_NEW) for p in jobs["conc"]]):
            ids = _chat_ids(tok, prompt)
            sp = SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)
            exp = P.prefill_export(ids, sp, connector="host")
            legs.append(_prefilled(D, ids, exp, sp, f"ref-legs-{i}"))
    finally:
        _stop_gateways(held, thread, [ctx])
        P.stop()
        D.stop()
    return dict(lone=lone, conc=[t for _s, t in conc], legs=legs)


def _worker_legs(ports, tok, jobs) -> list:
    """Each prompt's PD legs driven straight at the worker processes over
    gRPC (prefill on the first, decode on the second): (tokens, logprobs)."""
    import asyncio

    from smg_tpu_torch.gateway.worker_client import WorkerGenerateRequest
    from smg_tpu_torch.protocols.sampling import SamplingParams
    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    async def go():
        p, d = (GrpcWorkerClient(f"127.0.0.1:{port}") for port in ports)
        try:
            out = []
            for i, (prompt, n) in enumerate([(jobs["lone"], PD_NEW)]
                                            + [(q, PD_CONC_NEW) for q in jobs["conc"]]):
                ids = _chat_ids(tok, prompt)
                sp = SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)
                exp = await p.prefill_export(ids, sp)
                toks, lps = [], []
                async for c in d.generate_prefilled(
                        WorkerGenerateRequest(rid=f"legs-{i}", input_ids=ids, sampling=sp),
                        exp["first_token"], exp["k"], exp["v"]):
                    toks += c.token_ids
                    lps += c.logprobs
                out.append((toks, lps))
            return out
        finally:
            await p.close()
            await d.close()

    return asyncio.run(go())


def _job_result(port: int, job_id: str, timeout: float = LOOP_WAIT_S) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        st, job = _http(port, "GET", f"/jobs/{job_id}")
        if st != 200:
            raise AssertionError(f"/jobs/{job_id}: {st} {job}")
        if job["status"] in ("succeeded", "failed", "cancelled"):
            return job
        if time.monotonic() > deadline:
            raise AssertionError(f"job {job_id} still {job['status']}")
        time.sleep(0.1)


def pd_early_registration() -> dict:
    """Phase 14 (c)'s bare ``launch`` and its async ``POST /workers`` against
    B's port, which nothing listens on yet, started when phase 14 starts:
    the registration's retry budget (8 attempts over 35.5 s) then runs out
    under (a) and (b) instead of on (c)'s path.  Returns the gateway
    (``child``, ``port``), the workers' ports, the queued job and its
    answer (posted on a thread of its own, which ``launch_pd`` joins)."""
    import threading

    ports = {"a": _free_port(), "b": _free_port()}
    port = _free_port()
    held = dict(ports=ports, port=port,
                child=Child("launch", [*CLI, "launch", "--host", "127.0.0.1", "--port", port]))

    def post():  # on a thread of its own: (a) starts meanwhile
        try:
            _wait_http_up(port, held["child"], "bare launch")
            held["status"], held["late"] = _http(port, "POST", "/workers", {
                "url": f"127.0.0.1:{ports['b']}", "worker_id": "b", "async": True})
            held["t_late"] = time.perf_counter()
        except Exception as e:
            held["error"] = repr(e)

    held["thread"] = threading.Thread(target=post, name="pd-early-registration")
    held["thread"].start()
    return held


def launch_pd(cfg, dev, card: str, jobs: dict, expect, early: dict) -> dict:
    """Phase 14 (c): two of this script's own worker processes
    (``pd_worker_main``: the first ``PD_LAYERS`` layers widened to float32,
    ``PD_GRPC_PAGES`` pages each), each reporting its kernel launches and
    schedule when it exits.  ``POST /workers`` on a bare ``launch``: one
    registration against a port nothing listens on yet (async: 202, the job
    ends with the workflow failed), one synchronous (A); B, loaded
    meanwhile, then takes that port and ``POST /workflows/{id}/resume``
    registers it (the PD ``launch`` and ``_start_routing``'s gateways,
    started while that registration failed, register B then); a drain
    during a stream; a removed worker added back as a job.  Then ``launch
    --prefill-worker A --decode-worker B``: the lone and the 8 concurrent
    chats give the in-process PD's texts, and each prompt's legs straight
    at the workers its tokens, logprobs within 1e-4."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.tokenizer import MockTokenizer

    out = {}
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    early["thread"].join(LOOP_WAIT_S)
    if "late" not in early:
        early["child"].stop()
        raise AssertionError(f"the bare launch's registration: {early.get('error')}")
    ports = early["ports"]
    reports = {k: Path(tempfile.mkdtemp(prefix="smg_launch_")) / f"{k}.json" for k in ports}
    spec = dict(config=dataclasses.asdict(cfg), layers=PD_LAYERS, pages=PD_GRPC_PAGES,
                device=str(dev))

    def spawn(name, **extra):
        return Child(name, [sys.executable, REPO / "chip_smoke.py", "--pd-worker", json.dumps(
            {**spec, "port": ports[name], "report": str(reports[name]), **extra})])

    g1port = early["port"]
    children = {"g1": early["child"]}
    urls = {k: f"127.0.0.1:{p}" for k, p in ports.items()}
    hold = reports["b"].parent / "listen"
    routing = None
    try:
        children["a"] = spawn("a")
        # B's port was not listening when the registration was posted: it
        # retries, then fails
        st, late, t_late = early["status"], early["late"], early["t_late"]
        expect(st == 202 and late.get("status") == "queued", f"async POST /workers: {late}")
        # B loads now and takes its port once that registration has failed
        children["b"] = spawn("b", hold=str(hold))
        # the reference run in this process while they wait
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        p4 = {**{k: v.float() for k, v in full.items() if k != "layers"},
              "layers": {k: v[:PD_LAYERS].float() for k, v in full["layers"].items()}}
        del full
        cfg4 = dataclasses.replace(cfg, num_layers=PD_LAYERS, dtype="float32")
        ref = _pd_reference(cfg4, p4, dev, tok, jobs)
        del p4
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # every later gateway starts now: each registers both workers before
        # it binds, retrying B (8 attempts over 35.5 s from its first, which
        # comes after its start-up) until B takes its port below, so its
        # start-up runs while this waits and not beside the drain
        g2port = _free_port()
        children["g2"] = Child("launch-pd", [
            *CLI, "launch", "--host", "127.0.0.1", "--port", g2port,
            "--prefill-worker", urls["a"], "--decode-worker", urls["b"]])
        routing = _start_routing(urls)
        out["a_up_s"] = _grpc_up(ports["a"], children["a"], "worker a")
        st, added = _http(g1port, "POST", "/workers", {"url": urls["a"], "worker_id": "a"})
        expect(st == 200 and added["added"]["worker_id"] == "a"
               and added["workflow"]["status"] == "completed", f"sync POST /workers: {added}")
        job = _job_result(g1port, late["job_id"])
        out["late_failed_after_s"] = time.perf_counter() - t_late
        wf = job.get("result") or {}
        expect(job["status"] == "succeeded" and wf.get("status") == "failed"
               and wf["steps"]["model_info"]["status"] == "failed",
               f"the registration against a closed port: {job}")
        expect(_http(g1port, "GET", f"/workflows/{wf.get('instance_id')}")[1].get("status")
               == "failed", "the failed workflow is not listed as failed")
        hold.touch()
        t_go = time.perf_counter()
        _grpc_up(ports["b"], children["b"], "worker b")
        out["b_up_s"] = time.perf_counter() - t_go
        st, resumed = _http(g1port, "POST", f"/workflows/{wf['instance_id']}/resume")
        expect(st == 200 and resumed["status"] == "completed",
               f"resume after B came up: {st} {resumed}")
        listed = sorted(w["worker_id"] for w in _http(g1port, "GET", "/workers")[1]["workers"])
        expect(listed == ["a", "b"], f"/workers after the resume: {listed}")
        st, _text = _chat_text(g1port, _chat(jobs["conc"][0], PD_CONC_NEW))
        expect(st == 200, f"a chat after the resume: {st}")
        # the gateways started above bind once they registered B: their
        # start-up is over before the drain, whose stream has a window
        t_up = time.perf_counter()
        for child, port in [(children["g2"], g2port), *routing["gateways"].values()]:
            _wait_http_up(port, child, child.name)
        out["gateways_up_after_b_s"] = time.perf_counter() - t_up
        out["drain"] = _drain_check(g1port, jobs, expect)
        # the drained worker back, as a job
        gone = out["drain"]["drained"]
        st, again = _http(g1port, "POST", "/workers", {"url": urls[gone], "worker_id": gone,
                                                       "async": True})
        job = _job_result(g1port, again["job_id"]) if st == 202 else {}
        expect(st == 202 and job.get("status") == "succeeded"
               and job["result"]["status"] == "completed", f"async re-add: {st} {job}")
        out["g1_exit"] = children.pop("g1").stop()
        expect(out["g1_exit"] == 0, f"bare launch exit code {out['g1_exit']} after SIGTERM")
        # PD through launch
        _wait_http_up(g2port, children["g2"], "PD launch")
        types = {w["worker_id"]: w["type"]
                 for w in _http(g2port, "GET", "/workers")[1]["workers"]}
        expect(types == {urls["a"]: "prefill", urls["b"]: "decode"}, f"PD workers: {types}")
        st, lone = _chat_text(g2port, _chat(jobs["lone"], PD_NEW))
        expect(st == 200 and lone == ref["lone"],
               f"[launch/pd] lone chat: {st}, equal to in-process PD {lone == ref['lone']}")
        res = _in_threads(lambda b: _chat_text(g2port, b),
                          [(_chat(p, PD_CONC_NEW),) for p in jobs["conc"]])
        equal = sum(r == (200, w) for r, w in zip(res, ref["conc"]))
        expect(equal == len(res), f"[launch/pd] 8 concurrent: {equal}/{len(res)} equal")
        legs = _worker_legs((ports["a"], ports["b"]), tok, jobs)
        toks_equal = sum(a[0] == b[0] for a, b in zip(legs, ref["legs"]))
        lp_err = max(abs(x - y) for a, b in zip(legs, ref["legs"])
                     for x, y in zip(a[1], b[1]))
        expect(toks_equal == len(legs) and lp_err <= 1e-4,
               f"[launch/pd] legs: {toks_equal}/{len(legs)} token streams equal, logprob "
               f"max abs err {lp_err:.2e}")
        out.update(pd_lone_equal=lone == ref["lone"], pd_conc_equal=equal,
                   legs_tokens_equal=toks_equal, legs_logprob_max_abs_err=lp_err)
        out["g2_exit"] = children.pop("g2").stop()
        expect(out["g2_exit"] == 0, f"PD launch exit code {out['g2_exit']}")
        # the routing policies, over the same two workers
        started, routing = routing, None
        out["routing"] = launch_routing(urls, ports, expect, started=started)
    finally:
        if routing is not None:  # started, never handed over
            _stop_all({}, routing["gateways"], routing["tmp"])
        for name in list(children):
            code = children.pop(name).stop()
            out[f"{name}_exit"] = code
    expect(out.get("a_exit") == 0 and out.get("b_exit") == 0,
           f"worker exit codes {out.get('a_exit')}, {out.get('b_exit')}")
    launches = {"decode_attention": 0, "prefill_attention": 0}
    for name, path in reports.items():
        rep = json.loads(path.read_text()) if path.exists() else None
        shutil.rmtree(path.parent, ignore_errors=True)
        if rep is None:
            expect(False, f"worker {name} wrote no report")
            continue
        st = rep["stats"]
        want = {"decode_attention": PD_LAYERS * st["decode_columns"],
                "prefill_attention": PD_LAYERS * st["prefill_calls"]}
        expect(rep["launches"] == want, f"worker {name}: launches {rep['launches']} != {want}")
        # every generate arrived with rank -1: the workers have one replica
        # each, so no gateway pinned one (--dp-aware included)
        expect(set(rep["ranks"]) == {"-1"} and rep["ranks"]["-1"] > 0,
               f"worker {name}: data_parallel_rank on the wire {rep['ranks']}")
        out[f"{name}_report"] = rep
        for k in launches:
            launches[k] += rep["launches"][k]
    expect(min(launches.values()) > 0 and out.get("b_report", {}).get("stats", {}).get(
        "decode_columns", 0) > 0, f"launches in the workers {launches}")
    out["launches"] = launches
    print(f"  [launch/pd] A up in {out.get('a_up_s', 0):.1f} s, the registration against a "
          f"closed port failed after {out.get('late_failed_after_s', 0):.1f} s and resumed "
          f"once B, loaded meanwhile, took its port ({out.get('b_up_s', 0):.1f} s); PD through launch: lone and "
          f"{out.get('pd_conc_equal')}/8 chats equal to in-process PD, legs' logprobs within "
          f"{out.get('legs_logprob_max_abs_err', float('nan')):.2e}; launches in the "
          f"workers {launches} ({card})")
    return out


ROUTE_NEW = 4  # new tokens of every routing request of phase 14 (c)
ROUTE_PREFIX_TOKENS = 64  # prefix_hash's --prefix-token-count there


def _route_gateway(name: str, urls: dict, *flags) -> tuple:
    """A ``launch`` process in front of both workers with ``flags``, started
    (it registers both before it binds); returns (child, port)."""
    port = _free_port()
    child = Child(name, [*CLI, "launch", "--host", "127.0.0.1", "--port", port,
                         "--worker", urls["a"], "--worker", urls["b"], *flags])
    return child, port


def _routed_chat(port: int, ids) -> tuple:
    """(status, the decision, cached prompt tokens) of one chat: the
    decision is the newest of ``/debug/router``."""
    st, r = _http(port, "POST", "/v1/chat/completions", _chat(ids, ROUTE_NEW))
    cached = ((r.get("usage") or {}).get("prompt_tokens_details") or {}).get(
        "cached_tokens", 0) if st == 200 else None
    _st, router = _http(port, "GET", "/debug/router?limit=1")
    return st, router["models"][SERVE_MODEL]["decisions"][-1], cached


def _start_routing(urls: dict, parts: tuple = ("routing", "mesh")) -> dict:
    """Phase 14 (c)'s routing gateways and (d)'s mesh gateways, started and
    not waited for: {"t_start", "tmp", "gateways": {name: (child, port)},
    "mesh_gw"}.  Whatever started is stopped if a start fails."""
    started = dict(t_start=time.perf_counter(), tmp=Path(tempfile.mkdtemp(prefix="smg_mesh_")),
                   gateways={}, mesh_gw={})
    gateways = started["gateways"]
    try:
        if "mesh" in parts:
            started["mesh_gw"] = _mesh_gateways(urls, started["tmp"])
            gateways.update({f"mesh_{g}": started["mesh_gw"][g] for g in ("g1", "g2", "g3")})
        if "routing" in parts:
            for name, flags in (
                    ("prefix_hash", ("--policy", "prefix_hash", "--prefix-token-count",
                                     ROUTE_PREFIX_TOKENS)),
                    ("consistent_hashing", ("--policy", "consistent_hashing")),
                    ("cache_aware", ("--policy", "cache_aware")),
                    ("dp_aware", ("--dp-aware",))):
                gateways[name] = _route_gateway(f"launch-{name.replace('_', '-')}", urls,
                                                *flags)
    except BaseException:
        _stop_all({}, gateways, started["tmp"])
        raise
    return started


def launch_routing(urls: dict, ports: dict, expect,
                   parts: tuple = ("routing", "mesh"), started: dict | None = None) -> dict:
    """Phase 14 (c)'s routing policies over the two live worker processes,
    one ``launch`` process each, all four started together (their start-up
    is host work that overlaps), then checked in turn: ``prefix_hash`` (8
    chats in 2 families of a 300-token prefix: one worker per family, a
    family's later chats cached), ``consistent_hashing`` (12 prompts twice:
    the same worker each time; after ``DELETE /workers/{id}?drain`` of one
    worker, only its prompts move), ``cache_aware`` (``/debug/kv_index``
    shows the native tree, whose nodes the C++ index does not count; a
    shared-prefix chat goes to the worker holding the prefix) and
    ``--dp-aware`` (each worker reports ``dp_size`` 1; the ranks the workers
    received are checked at their exit: all -1).  Every gateway exits 0 on
    SIGTERM.  With ``mesh``, phase 14 (d)'s three mesh gateways start with
    the four and are checked first (``launch_mesh``); G3's death is read
    after the routing checks.  ``started`` (``_start_routing``) hands over
    gateways already started; they are stopped here as the others are."""
    import asyncio

    import numpy as np

    from smg_tpu_torch.rpc.client import GrpcWorkerClient

    rng = np.random.default_rng(1416)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    out: dict = {"started_early": started is not None}
    started = started or _start_routing(urls, parts)
    t_start, tmp, gateways, mesh_gw = (started[k] for k in ("t_start", "tmp", "gateways",
                                                            "mesh_gw"))
    try:
        for name, (child, port) in gateways.items():
            _wait_http_up(port, child, name)
        out["startup_s"] = time.perf_counter() - t_start
        if mesh_gw:
            t0 = time.perf_counter()
            out["mesh"] = launch_mesh(mesh_gw, urls, ids, expect)
            out["mesh_s"] = time.perf_counter() - t0
            print(f"  phase 14 (d)'s checks took {out['mesh_s']:.1f} s (G3's death is read "
                  "after the routing checks)")
        if "routing" not in parts:
            return _routing_end(out, gateways, t_start, tmp, expect)
        # prefix_hash: a family's chats share their first 64 ids
        t0 = time.perf_counter()
        port = gateways["prefix_hash"][1]
        families = [ids(300), ids(300)]
        picks = {0: [], 1: []}
        for i in range(8):
            fam = i % 2
            st, d, cached = _routed_chat(port, families[fam] + ids(30))
            expect(st == 200 and d["policy"] == "prefix_hash",
                   f"[routing/prefix_hash] chat {i}: {st} {d}")
            picks[fam].append((d["chosen"], cached))
        for fam, got in picks.items():
            expect(len({w for w, _ in got}) == 1 and all(c > 0 for _, c in got[1:]),
                   f"[routing/prefix_hash] family {fam}: workers and cached tokens {got}")
        out["prefix_hash"] = {f"family{f}": got for f, got in picks.items()}
        out["prefix_hash_s"] = time.perf_counter() - t0
        # consistent_hashing: stable keys; a drained worker's keys alone move.
        # The gateway may bind before its registration of the second worker
        # (started late, retried with backoff) ends: the keys spread only
        # once the ring holds both
        t0 = time.perf_counter()
        port = gateways["consistent_hashing"][1]
        out["consistent_hashing_wait_s"] = _until(
            lambda: len({w["worker_id"] for w in _http(port, "GET", "/workers")[1]["workers"]
                         if w.get("healthy", True)}) == 2,
            "[routing/consistent_hashing] both workers registered", timeout=LOOP_WAIT_S)
        prompts = [ids(40) for _ in range(12)]
        first = [_routed_chat(port, q)[1]["chosen"] for q in prompts]
        again = [_routed_chat(port, q)[1]["chosen"] for q in prompts]
        gone = first[0]
        st, removed = _http(port, "DELETE", f"/workers/{gone}?drain=5")
        after = [_routed_chat(port, q)[1]["chosen"] for q in prompts]
        moved = [i for i in range(len(prompts)) if after[i] != first[i]]
        expect(first == again and len(set(first)) == 2 and st == 200
               and moved == [i for i, w in enumerate(first) if w == gone],
               f"[routing/consistent_hashing] first {first}, again {again}, removal {st} "
               f"{removed}, after {after}")
        out["consistent_hashing"] = dict(first=first, after=after, drained=gone, moved=moved)
        out["consistent_hashing_s"] = time.perf_counter() - t0
        # cache_aware over the native tree
        t0 = time.perf_counter()
        port = gateways["cache_aware"][1]
        shared = ids(600)
        st_a, da, _ = _routed_chat(port, shared + ids(20))
        st_b, db, cached_b = _routed_chat(port, shared + ids(20))
        _st, kv = _http(port, "GET", "/debug/kv_index")
        trees = {k: g["tree"] for k, g in kv["gateway"].items() if "tree" in g}
        tree = trees.get(SERVE_MODEL, {})
        expect((st_a, st_b) == (200, 200) and db["chosen"] == da["chosen"]
               and db["outcome"] == "prefix_hit" and cached_b > 0,
               f"[routing/cache_aware] shared prefix: {da} then {db}, cached {cached_b}")
        expect(tree.get("elements", 0) > 0 and all(t["nodes"] is None for t in trees.values()),
               f"[routing/cache_aware] /debug/kv_index trees {trees}: not the native tree")
        out["cache_aware"] = dict(chosen=[da["chosen"], db["chosen"]], outcome=db["outcome"],
                                  cached=cached_b, tree=tree)
        out["cache_aware_s"] = time.perf_counter() - t0
        # --dp-aware: one replica per worker, so the router pins none
        t0 = time.perf_counter()
        port = gateways["dp_aware"][1]

        async def dp_sizes():
            sizes = {}
            for name, p in ports.items():
                client = GrpcWorkerClient(f"127.0.0.1:{p}")
                try:
                    sizes[name] = (await client.get_model_info())["dp_size"]
                finally:
                    await client.close()
            return sizes

        sizes = asyncio.run(dp_sizes())
        dp_chats = [_routed_chat(port, q)[0] for q in prompts[:4]]
        expect(sizes == {"a": 1, "b": 1} and dp_chats == [200] * 4,
               f"[routing/dp-aware] dp_size {sizes}, chats {dp_chats}")
        out["dp_aware"] = dict(dp_size=sizes)
        out["dp_aware_s"] = time.perf_counter() - t0
    except BaseException:
        if "exit_read" not in out:
            _stop_all(out, gateways, tmp)
        raise
    # G3's death is read before the gateways stop: their logs close then
    return _routing_end(out, gateways, t_start, tmp, expect)


def _stop_all(out: dict, gateways: dict, tmp: Path) -> None:
    """SIGTERM every gateway once (G3 has had its one), then each exit
    code."""
    for child, _port in gateways.values():
        child.terminate()
    for name, (child, _port) in gateways.items():
        out[f"{name}_exit"] = child.stop()
    out["exit_read"] = True
    shutil.rmtree(tmp, ignore_errors=True)


def _routing_end(out: dict, gateways: dict, t_start: float, tmp: Path, expect) -> dict:
    """The end of phase 14 (c)'s routing and (d)'s mesh: G3's death as G1
    and G2 saw it, every gateway stopped and its exit code checked, the
    readings printed."""
    mesh = out.get("mesh")
    if mesh is not None:
        died = mesh.pop("death_watch")()
        mesh["dead_after_s"] = died
        bound = MESH_DEATH_ROUNDS * MESH_INTERVAL_S
        expect(set(died) == {"g1", "g2"} and max(t for t, _how in died.values()) <= bound + 2,
               f"[mesh] G1 and G2 marked the stopped G3 dead after {died} s (bound "
               f"{MESH_DEATH_ROUNDS} rounds of {MESH_INTERVAL_S} s)")
        print(f"  [mesh] G3 stopped: G1 and G2 hold it dead after {died} (s, and whether "
              f"the gateway dialled it {MESH_SUSPECT_AFTER} times in vain or heard it from "
              f"its peer; rounds of {MESH_INTERVAL_S} s)")
    if "exit_read" not in out:
        _stop_all(out, gateways, tmp)
    for name in gateways:
        expect(out.get(f"{name}_exit") == 0,
               f"[routing/{name}] gateway exit {out.get(f'{name}_exit')}")
    out["seconds"] = time.perf_counter() - t_start
    if "prefix_hash" not in gateways:
        return out
    print(f"  [launch/routing] prefix_hash {out.get('prefix_hash')}; consistent_hashing "
          f"moved {out.get('consistent_hashing', {}).get('moved')} after draining "
          f"{out.get('consistent_hashing', {}).get('drained')}; cache_aware "
          f"{out.get('cache_aware')}; dp_size {out.get('dp_aware')}; {len(gateways)} launch "
          f"processes up {out.get('startup_s', float('nan')):.1f} s after their start"
          f"{' (during the failing registration: they wait for B)' if out['started_early'] else ''}"
          f", {out['seconds']:.1f} s in all")
    return out


MESH_WAIT_S = 30.0  # the longest a mesh change may take to reach a peer
MESH_INTERVAL_S = 1.0  # launch's gossip interval (not a flag)
MESH_SUSPECT_AFTER = 3  # launch's missed rounds before a peer is dead (not a flag)
# gossip rounds G1 and G2 get to mark a stopped G3 dead: each round dials one
# live peer at random (two here), so 3 misses take 6 rounds on average, and
# fewer than 3 in 20 has a chance of 2e-4 per gateway
MESH_DEATH_ROUNDS = 20
MESH_FAMILIES = 4  # 300-token prefix families routed through G1, then G2


def _mesh_certs(tmp: Path) -> list:
    """``--mesh-tls-*`` flags of a CA and one node certificate it signed,
    made with the ``openssl`` CLI in ``tmp``, as the reference's mTLS test
    makes them; [] (plaintext gossip) where the host has no ``openssl``."""
    if shutil.which("openssl") is None:
        return []

    def run(*args):
        subprocess.run(args, check=True, capture_output=True, cwd=tmp)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", "ca.key",
        "-out", "ca.crt", "-days", "1", "-subj", "/CN=mesh-ca")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout", "node.key", "-out",
        "node.csr", "-subj", "/CN=mesh-node")
    run("openssl", "x509", "-req", "-in", "node.csr", "-CA", "ca.crt", "-CAkey", "ca.key",
        "-CAcreateserial", "-out", "node.crt", "-days", "1")
    return ["--mesh-tls-cert", tmp / "node.crt", "--mesh-tls-key", tmp / "node.key",
            "--mesh-tls-ca", tmp / "ca.crt"]


def _mesh_gateways(urls: dict, tmp: Path) -> dict:
    """Phase 14 (d)'s three ``launch --mesh-port`` processes, started: G1
    with both workers, G2 and G3 seeded from G1 with none; all with one
    word-level ``--gateway-tokenizer-path`` (a mesh-born worker brings no
    tokenizer bundle) and, where the host has ``openssl``, mutual TLS.
    Returns {"g1": (child, port), ..., "tls": bool}."""
    from smg_tpu_torch.models.config import PRESETS

    write_tokenizer(tmp, PRESETS[SERVE_MODEL]().vocab_size)
    tls = _mesh_certs(tmp)
    mesh_ports = {g: _free_port() for g in ("g1", "g2", "g3")}
    out = {"tls": bool(tls)}
    for g, mport in mesh_ports.items():
        flags = (["--worker", urls["a"], "--worker", urls["b"]] if g == "g1"
                 else ["--mesh-seed", f"127.0.0.1:{mesh_ports['g1']}"])
        port = _free_port()
        out[g] = (Child(f"mesh-{g}", [*CLI, "launch", "--host", "127.0.0.1", "--port", port,
                                      "--mesh-port", mport, "--gateway-tokenizer-path", tmp,
                                      *tls, *flags]), port)
    return out


def _inserted_prefixes(port: int) -> float:
    """The gateway's ``smg_cache_inserted_prefixes`` (every model summed)."""
    _st, text = _http(port, "GET", "/metrics")
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("smg_cache_inserted_prefixes{"))


def _until(cond, what: str, timeout: float = MESH_WAIT_S) -> float:
    """Seconds until ``cond()`` holds (polled every 20 ms)."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def launch_mesh(mesh: dict, urls: dict, ids, expect) -> dict:
    """Phase 14 (d)'s checks over the running mesh gateways: G2 and G3 list
    G1's workers; a chat through G2 and G3 gives G1's greedy text; prefixes
    of ``MESH_FAMILIES`` 300-token families routed by ``cache_aware``
    through G1 raise G2's ``smg_cache_inserted_prefixes`` by as many and go
    to the same workers through G2; a ``POST /workers`` on G2 appears on G1
    and ``DELETE /workers/{id}`` on G1 leaves G2.  Last, G3 gets one
    SIGTERM; a thread then watches G1's and G2's logs for ``gossip peer
    <G3> marked dead`` (``mesh_death``'s result, read after the routing
    checks).  Returns (readings, the thread's join function)."""
    (c1, g1), (c2, g2), (c3, g3) = mesh["g1"], mesh["g2"], mesh["g3"]
    out: dict = {"tls": mesh["tls"]}
    want = sorted(urls.values())

    def listed(port):
        return sorted(w["url"] for w in _http(port, "GET", "/workers")[1]["workers"])

    expect(listed(g1) == want, f"[mesh] G1 lists {listed(g1)}, want {want}")
    out["workers_converged_s"] = _until(lambda: listed(g2) == listed(g3) == want,
                                        "[mesh] G2 and G3 list G1's workers")
    # one chat through each: G1's greedy text; each creates the gateway's
    # cache_aware policy, whose inserts the others replicate
    prompt = ids(200)
    texts = [_chat_text(p, _chat(prompt, ROUTE_NEW * 4)) for p in (g1, g2, g3)]
    expect(texts[0][0] == 200 and texts[1] == texts[2] == texts[0],
           f"[mesh] one chat through G1, G2, G3: {[t[0] for t in texts]}, texts equal "
           f"{texts[1] == texts[0]}, {texts[2] == texts[0]}")
    # every gateway's insert replicated to G2: its own and the two others
    _until(lambda: _inserted_prefixes(g2) == 3, "[mesh] G2 holds the 3 chats' prefixes")
    families = [ids(300) for _ in range(MESH_FAMILIES)]
    picks = []
    for fam in families:
        st, d, _cached = _routed_chat(g1, fam + ids(30))
        expect(st == 200 and d["policy"] == "cache_aware", f"[mesh] G1 family chat: {st} {d}")
        picks.append(d["chosen"])
    t0 = time.perf_counter()
    _until(lambda: _inserted_prefixes(g2) == 3 + MESH_FAMILIES,
           f"[mesh] G2's inserted prefixes rise by {MESH_FAMILIES}")
    out["tree_replicated_s"] = time.perf_counter() - t0
    via_g2 = []
    for fam in families:
        st, d, _cached = _routed_chat(g2, fam + ids(30))
        via_g2.append((st, d["chosen"], d["outcome"]))
    expect(all(st == 200 and w == p and o == "prefix_hit"
               for (st, w, o), p in zip(via_g2, picks)),
           f"[mesh] families through G2 {via_g2}, G1 chose {picks}")
    out["families"] = dict(g1=picks, g2=via_g2)
    # a worker registered on G2 reaches G1; one G1 removes leaves G2
    st, added = _http(g2, "POST", "/workers", {"url": urls["b"], "worker_id": "mesh-b"})
    expect(st == 200, f"[mesh] POST /workers on G2: {st} {added}")
    t0 = time.perf_counter()
    _until(lambda: "mesh-b" in {w["worker_id"] for w in _http(g1, "GET", "/workers")[1][
        "workers"]}, "[mesh] G2's new worker on G1")
    out["add_replicated_s"] = time.perf_counter() - t0
    gone = urls["a"]
    st, removed = _http(g1, "DELETE", f"/workers/{gone}")
    expect(st == 200, f"[mesh] DELETE /workers/{gone} on G1: {st} {removed}")
    t0 = time.perf_counter()
    _until(lambda: gone not in listed(g2), "[mesh] G1's removal on G2")
    out["remove_replicated_s"] = time.perf_counter() - t0
    # G3 stops; G1 and G2 must mark it dead
    import re

    m = re.search(r"gossip node (\S+) listening on", c3.tail(10**7))
    g3_id = m.group(1) if m else None
    expect(g3_id is not None, "[mesh] G3 logged no node id")
    # a node that dials G3 in vain logs "gossip peer <G3> marked dead"; one
    # that first hears of the death from its peer takes it silently (death
    # wins at an equal incarnation), and either way its partition detector
    # then logs G3 unreachable at its next round
    lines = (f"gossip peer {g3_id} marked dead",
             "-> partitioned_with_quorum (reachable=2 unreachable=1)")
    logs = {"g1": c1, "g2": c2}
    start = {name: len(child.tail(10**7)) for name, child in logs.items()}
    c3.terminate()
    t_term = time.perf_counter()
    seen: dict = {}

    def watch():
        deadline = t_term + MESH_DEATH_ROUNDS * MESH_INTERVAL_S + 5
        while len(seen) < 2 and time.perf_counter() < deadline:
            for name, child in logs.items():
                new = child.tail(10**7)[start[name]:]
                if name not in seen and any(line in new for line in lines):
                    seen[name] = (time.perf_counter() - t_term,
                                  "dialled" if lines[0] in new else "heard")
            time.sleep(0.05)
        return dict(seen)

    out["death_watch"] = _timed_in_thread(watch)
    print(f"  [mesh] {'mTLS' if mesh['tls'] else 'plaintext'} gossip: G2 and G3 listed G1's "
          f"workers {out['workers_converged_s']:.2f} s after all were up; chats through G1, "
          f"G2, G3 equal; {MESH_FAMILIES} families replicated to G2 in "
          f"{out['tree_replicated_s']:.2f} s and routed there as on G1; an add on G2 reached "
          f"G1 in {out['add_replicated_s']:.2f} s, a removal on G1 left G2 in "
          f"{out['remove_replicated_s']:.2f} s")
    return out


def _drain_check(port: int, jobs: dict, expect) -> dict:
    """``DELETE /workers/{id}?drain=10`` while that worker streams
    ``LAUNCH_DRAIN_NEW`` tokens: the stream ends whole, and a chat sent
    during the drain goes to the other worker."""
    import threading

    def workers():
        return {w["worker_id"]: w for w in _http(port, "GET", "/workers")[1]["workers"]}

    result = {}
    stream = threading.Thread(target=lambda: result.update(stream=_sse(
        port, "/v1/chat/completions", _chat(jobs["conc"][1], LAUNCH_DRAIN_NEW, stream=True,
                                            stream_options={"include_usage": True}))))
    stream.start()
    busy = None
    deadline = time.monotonic() + 30
    while busy is None and time.monotonic() < deadline and stream.is_alive():
        busy = next((wid for wid, w in workers().items() if w["load"] > 0), None)
        time.sleep(0.005)
    if busy is None:
        stream.join(LOOP_WAIT_S)
        raise AssertionError("the drain stream ended before a worker showed its load")
    before = workers()
    removal = threading.Thread(target=lambda: result.update(
        removed=_http(port, "DELETE", f"/workers/{busy}?drain=10")))
    removal.start()
    time.sleep(0.05)
    st, _text = _chat_text(port, _chat(jobs["conc"][2], PD_CONC_NEW))
    during = workers()
    removal.join(LOOP_WAIT_S)
    stream.join(LOOP_WAIT_S)
    other = next(w for w in before if w != busy)
    sst, frames = result["stream"]
    n_content = sum(1 for _t, f in frames if f != "[DONE]" and f.get("choices")
                    and f["choices"][0]["delta"].get("content"))
    # the draining worker is gone from the registry once its stream ended
    busy_after = during.get(busy, before[busy])["total_requests"]
    ok = (st == 200 and busy_after == before[busy]["total_requests"]
          and during[other]["total_requests"] == before[other]["total_requests"] + 1
          and result["removed"][0] == 200 and result["removed"][1]["drained"] is True
          and sst == 200 and frames[-1][1] == "[DONE]" and n_content > 0
          and busy not in workers())
    expect(ok, f"drain: chat {st}; requests before {before} during {during}; removal "
               f"{result.get('removed')}; stream {sst}, {n_content} content frames")
    return dict(drained=busy, removal=result["removed"][1], stream_frames=n_content)


def phase_launch(dev, card: str, preset: str = SERVE_MODEL,
                 parts: tuple = ("grpc", "http", "pd")) -> dict:
    """Phase 14, ``launch``: (a) ``worker`` and ``launch`` processes over
    gRPC at full width and depth, (b) ``serve`` behind ``launch`` over
    HTTP, (c) registration, drain, resume, PD and the routing policies
    through ``launch`` over two 4-layer float32 worker processes of this
    script; ``parts`` names which of (a)-(c) run.  Full-depth processes run
    one at a time: each sizes its KV to most of the card."""
    import gc

    import torch

    from smg_tpu_torch.models.config import PRESETS

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        print(f"  free before phase 14: {free} of {total} bytes")
    cfg = PRESETS[preset]()
    jobs = _pd_jobs(14)
    failures: list = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [launch] CHECK FAILED: {what}")

    out = {}
    # (c)'s registration against a closed port runs out its retries under (a)
    # and (b)
    early = pd_early_registration() if "pd" in parts else None
    try:
        for name, fn in (("grpc", lambda: launch_grpc(preset, dev, card, jobs, expect)),
                         ("http", lambda: launch_http(preset, dev, card, jobs, expect)),
                         ("pd", lambda: launch_pd(cfg, dev, card, jobs, expect, early))):
            if name not in parts:
                continue
            t0 = time.perf_counter()
            out[name] = fn()
            out[name]["seconds"] = time.perf_counter() - t0
            print(f"  phase 14 ({name}) took {out[name]['seconds']:.1f} s")
    finally:
        if early is not None and "pd" not in out and early["child"].alive():
            early["child"].stop()  # (c) never took it over
    out["launches"] = out["pd"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 14 took {out['seconds']:.1f} s ({card})")
    if failures:
        raise AssertionError(f"phase 14: {len(failures)} checks failed: {failures}")
    return out


RESP_NEW = 32  # output tokens of every phase-15 turn
RESP_REPS = 3  # chains of (b), for the medians of the per-turn wall times
RESP_WORDS = (120, 160, 200)  # words of each turn's user input
MCP_LABEL, MCP_TOOL = "tools", "lookup"


class LoopServer:
    """An aiohttp app on 127.0.0.1 served from a loop thread of its own;
    a subclass lists its ``routes()`` as (method, path, handler)."""

    def __init__(self):
        import asyncio
        import threading

        self.port = _free_port()
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self.thread = threading.Thread(target=self._run, name=type(self).__name__, daemon=True)
        self.thread.start()
        if not self._ready.wait(30):
            raise AssertionError(f"{type(self).__name__} did not start")

    def routes(self) -> list:
        raise NotImplementedError

    def _run(self) -> None:
        import asyncio

        from aiohttp import web

        async def serve():
            app = web.Application()
            for method, path, handler in self.routes():
                app.router.add_route(method, path, handler)
            self.runner = web.AppRunner(app)
            await self.runner.setup()
            await web.TCPSite(self.runner, "127.0.0.1", self.port).start()
            self._ready.set()

        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(serve())
        self.loop.run_forever()

    def stop(self) -> None:
        import asyncio

        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


class SmokeMcpServer(LoopServer):
    """A small MCP server (JSON-RPC 2.0 on 127.0.0.1): ``initialize``,
    ``tools/list`` and ``tools/call`` of one tool, ``lookup``, whose answer
    is a few words; it counts the calls."""

    def __init__(self):
        self.calls: list = []
        super().__init__()

    def routes(self) -> list:
        return [("POST", "/mcp", self.handle)]

    async def handle(self, request):
        from aiohttp import web

        body = await request.json()
        method, params = body["method"], body.get("params") or {}
        if method == "initialize":
            result = {"protocolVersion": params.get("protocolVersion"),
                      "capabilities": {"tools": {}},
                      "serverInfo": {"name": "chip-smoke", "version": "1"}}
        elif method == "tools/list":
            result = {"tools": [{"name": MCP_TOOL, "description": "look a word up",
                                 "inputSchema": {"type": "object", "properties": {
                                     "q": {"type": "string"}}}}]}
        elif method == "tools/call" and params.get("name") == MCP_TOOL:
            q = params.get("arguments", {}).get("q", "")
            self.calls.append(q)
            result = {"content": [{"type": "text", "text": f"w4242 w4343 w4444 {q}"}]}
        else:
            return web.json_response({"jsonrpc": "2.0", "id": body.get("id"),
                                      "error": {"code": -32601, "message": method}})
        return web.json_response({"jsonrpc": "2.0", "id": body.get("id"), "result": result})


def _sse_events(port: int, body: dict) -> tuple:
    """A streamed ``/v1/responses``: (status, [(event name, payload)])."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/responses", method="POST",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=LOOP_WAIT_S) as resp:
        raw = resp.read().decode()
        status = resp.status
    events = []
    for block in raw.strip().split("\n\n"):
        lines = dict(line.split(": ", 1) for line in block.split("\n"))
        events.append((lines["event"], json.loads(lines["data"])))
    return status, events


def _stream_events_of(output: list) -> list:
    """The event names ``ResponsesHandler.create_stream`` gives ``output``."""
    names = ["response.created"]
    for item in output:
        names.append("response.output_item.added")
        kinds = {"message": ("output_text", "response.output_text.delta"),
                 "reasoning": ("reasoning_text", "response.reasoning_text.delta")}
        if item.get("type") in kinds:
            part, event = kinds[item["type"]]
            names += [event for c in item.get("content", [])
                      if c.get("type") == part and c.get("text")]
        names.append("response.output_item.done")
    return names + ["response.completed"]


def _output_text(body: dict) -> str:
    return "".join(c.get("text", "") for o in body["output"] if o.get("type") == "message"
                   for c in o.get("content", []) if c.get("type") == "output_text")


def _timed_http(port: int, method: str, path: str, body=None, headers=None) -> tuple:
    t0 = time.perf_counter()
    st, out = _http(port, method, path, body, headers)
    return st, out, (time.perf_counter() - t0) * 1e3


def phase_responses(dev, card: str, preset: str = SERVE_MODEL,
                    parts: tuple = ("responses", "messages", "realtime")) -> dict:
    """Phase 15, the Responses API: one in-process ``serve`` from the command
    line's own assembly (``_run_gateway``) at full width and depth with
    ``--storage sqlite:``, ``--mcp-config-path`` naming this script's MCP
    server and ``--plugins`` loading phase 17's plugin; checks (a)-(f) and
    the readings (module docstring).  Then, over the same gateway and
    engine, phase 16 (``"messages"`` in ``parts``): the Anthropic Messages
    API, a ``launch --provider-config`` front in a process of its own
    (started first, so its start-up overlaps the engine's), and a dedicated
    router; then phase 17 (``"realtime"``): the Realtime, Interactions and
    transcription APIs and the plugin on the gateway and the front."""
    import asyncio
    import gc
    import threading

    import torch

    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.config.validation import raise_on_errors, validate_cli_args
    from smg_tpu_torch.gateway import launch
    from smg_tpu_torch.mcp import sessions as mcp_sessions

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        print(f"  free before phase 15: {free} of {total} bytes")
    failures: list = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [responses] CHECK FAILED: {what}")

    tmp = Path(tempfile.mkdtemp(prefix="smg_resp_"))
    port = _free_port()
    plugin = _smoke_plugin(tmp)
    mcp = SmokeMcpServer()
    (tmp / "mcp.json").write_text(json.dumps(
        [{"name": MCP_LABEL, "url": f"http://127.0.0.1:{mcp.port}/mcp"}]))
    # (f) an unknown storage scheme: startup fails with the reference's
    # error before the engine loads (the card's memory is untouched)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    bad = build_parser().parse_args(["serve", "--model-preset", preset, "--device", str(dev),
                                     "--port", str(_free_port()), "--storage", "nosuch://x"])
    t0 = time.perf_counter()
    try:
        asyncio.run(launch._run_gateway(bad, stop=asyncio.Event()))
        expect(False, "--storage nosuch://x started")
    except ValueError as e:
        expect(str(e) == "unknown storage spec 'nosuch://x'", f"--storage nosuch://x: {e!r}")
    bad_s = time.perf_counter() - t0
    expect((torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0) == before,
           "an engine loaded before the storage spec was refused")
    # the gateway: serve's own assembly on a loop thread; the context is
    # taken from serve_context on its way in (for the engine's schedule)
    args = build_parser().parse_args([
        "serve", "--model-preset", preset, *LAUNCH_ENGINE, "--device", str(dev),
        "--host", "127.0.0.1", "--port", str(port),
        "--storage", f"sqlite:{tmp / 'conv.db'}", "--mcp-config-path", str(tmp / "mcp.json"),
        "--plugins", str(plugin)])
    raise_on_errors(validate_cli_args(args))
    held: dict = {}
    real_serve_context = launch.serve_context

    async def serve_context(ctx, *a, **kw):
        held["ctx"] = ctx
        return await real_serve_context(ctx, *a, **kw)

    async def run_gateway():
        held["loop"], held["stop"] = asyncio.get_running_loop(), asyncio.Event()
        await launch._run_gateway(args, stop=held["stop"])

    def gateway_thread():
        try:
            asyncio.run(run_gateway())
        except BaseException as e:  # reported by the waiting side
            held["error"] = e

    # the handler's own steps, timed where it calls them: (name, ms) in order
    spans: list = []

    def timed(name, fn):
        async def run(*a, **kw):
            t = time.perf_counter()
            try:
                return await fn(*a, **kw)
            finally:
                spans.append((name, (time.perf_counter() - t) * 1e3))
        return run

    real_session = {k: getattr(mcp_sessions.McpSession, k) for k in ("call_tool", "tools")}
    launch.serve_context = serve_context
    for k, fn in real_session.items():
        setattr(mcp_sessions.McpSession, k, timed(k, fn))
    t_start = time.perf_counter()
    front = (_provider_front(tmp, port, preset, plugin)
             if {"messages", "realtime"} & set(parts) else None)
    server = threading.Thread(target=gateway_thread, name="responses-gateway")
    server.start()
    out: dict = {}
    try:
        deadline = time.monotonic() + LOOP_WAIT_S
        while True:
            try:
                if _http(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                pass
            if "error" in held or not server.is_alive():
                raise AssertionError(f"serve did not start: {held.get('error')!r}")
            if time.monotonic() > deadline:
                raise AssertionError("serve did not come up")
            time.sleep(0.1)
        out["startup_s"] = time.perf_counter() - t_start
        engine = held["ctx"].registry.get(SERVE_WORKER).client.engine
        L = engine.config.model.num_layers
        print(f"  serve --storage sqlite: --mcp-config-path came up in {out['startup_s']:.1f} s "
              f"({engine.runner.spec.num_pages} pages); --storage nosuch://x refused in "
              f"{bad_s:.2f} s")
        storage = held["ctx"].responses.storage
        for k in ("response_chain", "list_items", "store_response", "add_items"):
            setattr(storage, k, timed(k, getattr(storage, k)))
        if "responses" in parts:
            out.update(_responses_checks(port, engine, preset, mcp, spans, L, expect, dev,
                                         card))
        if "messages" in parts:
            out["messages"] = _messages_checks(port, engine, preset, front, L, expect, dev,
                                               card)
        if "realtime" in parts:
            out["realtime"] = _realtime_checks(port, held, preset, front, L, expect, dev, card)
    finally:
        if front is not None:
            code = front[0].stop()
            expect(code == 0, f"the provider front exited {code}")
        launch.serve_context = real_serve_context
        for k, fn in real_session.items():
            setattr(mcp_sessions.McpSession, k, fn)
        if "stop" in held:
            held["loop"].call_soon_threadsafe(held["stop"].set)
        server.join(LOOP_WAIT_S)
        mcp.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if server.is_alive():
        raise AssertionError("the gateway did not shut down")
    if "ctx" in held:  # aiohttp keeps finished apps, with their contexts
        for w in held["ctx"].registry.list():
            held["ctx"].registry.remove(w.worker_id)
    held.clear()
    engine = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    later = [n for n, part in (("16", "messages"), ("17", "realtime")) if part in parts]
    print(f"  phase 15{''.join(f', {n}' for n in later)} took {out['seconds']:.1f} s ({card})")
    if failures:
        raise AssertionError(f"phase 15: {len(failures)} checks failed: {failures}")
    return out


def _responses_checks(port, engine, model, mcp, spans, L, expect, dev, card) -> dict:
    """Phase 15's checks (a)-(f) and readings against the engine served on
    ``port`` under the model id ``model``; ``spans`` collects (step, ms) of
    the handler's storage and MCP calls as they happen."""
    import numpy as np
    import torch

    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    rng = np.random.default_rng(15)
    words = lambda n: _words(rng.integers(1000, 120000, n).tolist())  # noqa: E731
    out: dict = {}

    def flush():
        st, body = _http(port, "POST", "/flush_cache")
        if st != 200 or body["flushed"].get(SERVE_WORKER) is not True:
            raise AssertionError(f"/flush_cache: {st} {body}")

    def responses(body, headers=None):
        return _timed_http(port, "POST", "/v1/responses",
                           {"model": model, "max_output_tokens": RESP_NEW,
                            "temperature": 0, **body}, headers)

    # the chat requests the handler makes carry the configured MCP tool
    st, listed = _http(port, "POST", "/v1/responses", {
        "model": model, "input": words(8), "max_output_tokens": 1, "temperature": 0})
    tools = [{"type": "function", "function": {"name": t["name"], "description": t["description"],
                                               "parameters": t["input_schema"]}}
             for o in listed["output"] if o["type"] == "mcp_list_tools" for t in o["tools"]]
    expect(st == 200 and [t["function"]["name"] for t in tools] == [MCP_TOOL],
           f"the configured MCP server's tools: {st} {listed}")

    def chat(messages):
        return _timed_http(port, "POST", "/v1/chat/completions", {
            "model": model, "messages": messages, "max_tokens": RESP_NEW,
            "temperature": 0, "tools": tools})

    # (a) conversations and their items
    items = [{"type": "message", "role": "user", "content": words(5)},
             {"type": "message", "role": "assistant",
              "content": [{"type": "output_text", "text": words(3)}]}]
    st, conv = _http(port, "POST", "/v1/conversations", {"metadata": {"k": "v"}, "items": items})
    expect(st == 200 and conv["object"] == "conversation", f"(a) create: {st} {conv}")
    cid = conv["id"]
    st, got = _http(port, "GET", f"/v1/conversations/{cid}")
    expect(st == 200 and got["metadata"] == {"k": "v"}, f"(a) get: {st} {got}")
    st, listed = _http(port, "GET", f"/v1/conversations/{cid}/items")
    expect(st == 200 and [i["content"] for i in listed["data"]] == items, f"(a) items: {listed}")
    more = [{"type": "message", "role": "user", "content": words(4)}]
    st, added = _http(port, "POST", f"/v1/conversations/{cid}/items", {"items": more})
    st2, listed = _http(port, "GET", f"/v1/conversations/{cid}/items")
    expect(st == st2 == 200 and len(added["data"]) == 1
           and [i["content"] for i in listed["data"]] == items + more, f"(a) add: {listed}")
    st, upd = _http(port, "POST", f"/v1/conversations/{cid}", {"metadata": {"u": 1}})
    expect(st == 200 and upd["metadata"] == {"k": "v", "u": 1}, f"(a) update: {st} {upd}")
    st, _ = _http(port, "DELETE", f"/v1/conversations/{cid}")
    st2, gone = _http(port, "DELETE", f"/v1/conversations/{cid}")
    expect(st == 200 and st2 == 404, f"(a) delete: {st} then {st2} {gone}")

    # (b) three greedy turns chained by previous_response_id, each against
    # a direct chat of the same messages; the radix cache flushed before
    # every call (bf16 over a cached prefix rounds otherwise)
    inputs = [[words(n) for n in RESP_WORDS] for _ in range(RESP_REPS)]
    wall = {"responses": [[], [], []], "chat": [[], [], []]}
    steps: list = [[], [], []]  # per turn: {handler step: ms} of each rep
    last = None
    for rep in range(RESP_REPS):
        prev, messages = None, []
        for turn, text in enumerate(inputs[rep]):
            flush()
            n_spans = len(spans)
            st, body, ms = responses({"input": text, **(
                {"previous_response_id": prev} if prev else {})})
            mine: dict = {}
            for name, step_ms in spans[n_spans:]:
                mine[name] = mine.get(name, 0.0) + step_ms
            steps[turn].append(mine)
            expect(st == 200 and body["status"] == "completed", f"(b) turn {turn}: {st} {body}")
            messages.append({"role": "user", "content": text})
            flush()
            st, direct, cms = chat(messages)
            expect(st == 200, f"(b) direct chat {turn}: {st}")
            got_text, want = _output_text(body), direct["choices"][0]["message"]["content"]
            expect(got_text == want, f"(b) rep {rep} turn {turn}: {got_text!r} != chat {want!r}")
            expect(body["usage"]["output_tokens"] <= RESP_NEW, f"(b) usage {body['usage']}")
            if turn == 2:
                u, c = body["usage"], direct["usage"]
                expect((u["input_tokens"], u["output_tokens"]) ==
                       (c["prompt_tokens"], c["completion_tokens"]),
                       f"(b) turn 3 usage {u} != its chat call's {c}")
            messages.append({"role": "assistant", "content": want})
            wall["responses"][turn].append(ms)
            wall["chat"][turn].append(cms)
            prev, last = body["id"], body
    st, stored = _http(port, "GET", f"/v1/responses/{last['id']}")
    expect(st == 200 and all(stored[k] == last[k] for k in
                             ("id", "status", "model", "output", "previous_response_id",
                              "usage")), f"(b) GET the stored turn: {st} {stored}")
    st, _ = _http(port, "DELETE", f"/v1/responses/{last['id']}")
    st2, _ = _http(port, "GET", f"/v1/responses/{last['id']}")
    expect(st == 200 and st2 == 404, f"(b) DELETE then GET: {st} {st2}")
    out["wall_ms"] = {k: [statistics.median(v) for v in per] for k, per in wall.items()}
    out["handler_ms"] = [r - c for r, c in zip(out["wall_ms"]["responses"],
                                               out["wall_ms"]["chat"])]
    out["step_ms"] = [{k: statistics.median(s.get(k, 0.0) for s in per)
                       for k in sorted({k for s in per for k in s})} for per in steps]
    print(f"  (b) wall ms per turn (medians of {RESP_REPS}, cold radix): /v1/responses "
          + ", ".join(f"{x:.2f}" for x in out["wall_ms"]["responses"]) + "; direct chat "
          + ", ".join(f"{x:.2f}" for x in out["wall_ms"]["chat"]) + "; handler "
          + ", ".join(f"{x:+.2f}" for x in out["handler_ms"]) + f" ({card})")
    print("  (b) the handler's storage and MCP steps per turn (medians, ms): " + "; ".join(
        ", ".join(f"{k} {v:.2f}" for k, v in s.items()) for s in out["step_ms"]))

    # (c) the same three turns through a conversation, the radix cache warm
    # between them; kernel launches counted over exactly these turns
    st, conv = _http(port, "POST", "/v1/conversations", {})
    cid = conv["id"]
    flush()
    for k in engine.runner.stats:
        engine.runner.stats[k] = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dk.launches = pk.launches = 0
    outputs = []
    for turn, text in enumerate(inputs[0]):
        st, body, _ms = responses({"input": text, "conversation": cid},
                                  headers={"X-Request-Id": f"conv-turn-{turn}"})
        expect(st == 200 and body["conversation"] == {"id": cid}, f"(c) turn {turn}: {st}")
        outputs.append(body["output"])
    turn3 = body
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
    sched = {k: engine.runner.stats[k] for k in ("decode_columns", "prefill_calls")}
    want = {"decode_attention": L * sched["decode_columns"],
            "prefill_attention": L * sched["prefill_calls"]}
    expect(launches == want and min(launches.values()) > 0,
           f"(c) launches {launches} != {want} ({sched})")
    out["launches"], out["schedule"] = launches, sched
    st, listed = _http(port, "GET", f"/v1/conversations/{cid}/items")
    want_items = []
    for text, output in zip(inputs[0], outputs):
        want_items += [{"role": "user", "content": text}, *output]
    expect(st == 200 and [i["content"] for i in listed["data"]] == want_items,
           f"(c) stored items != inputs + outputs ({len(listed['data'])} vs {len(want_items)})")
    st, router = _http(port, "GET", "/debug/router?limit=64")
    dec = [d for d in router["models"][model]["decisions"]
           if d["request_id"] == "conv-turn-2-0"]
    expect(st == 200 and len(dec) == 1 and dec[0]["reconciled"], f"(c) turn 3's decision: {dec}")
    out["turn3"] = dict(prompt_tokens=turn3["usage"]["input_tokens"],
                        cached_tokens=dec[0]["worker_cached_tokens"] if dec else None,
                        predicted_match_tokens=dec[0]["predicted_match_tokens"] if dec else None)
    expect(out["turn3"]["cached_tokens"], f"(c) turn 3 reused no prefix: {out['turn3']}")
    print(f"  (c) launches over the three conversation turns {launches} = {L} x {sched}; "
          f"turn 3: {out['turn3']['prompt_tokens']} prompt tokens, "
          f"{out['turn3']['cached_tokens']} cached (predicted "
          f"{out['turn3']['predicted_match_tokens']})")

    # (d) streaming: the events create_stream defines, deltas joining to the
    # non-streamed text
    text = words(150)
    flush()
    st, whole, _ms = responses({"input": text})
    flush()
    st2, events = _sse_events(port, {"model": model, "input": text, "stream": True,
                                     "max_output_tokens": RESP_NEW, "temperature": 0})
    done = events[-1][1].get("response", {}) if events else {}
    expect(st == st2 == 200 and [n for n, _ in events] == _stream_events_of(done.get("output", [])),
           f"(d) events {[n for n, _ in events]}")
    expect([p["sequence_number"] for _, p in events] == list(range(1, len(events) + 1)),
           "(d) sequence numbers")
    deltas = "".join(p["delta"] for n, p in events if n == "response.output_text.delta")
    expect(deltas == _output_text(whole), f"(d) deltas {deltas!r} != {_output_text(whole)!r}")

    # (e) the MCP round trip through an approval
    def approval_conv(key):
        st, conv = _http(port, "POST", "/v1/conversations", {"items": [{
            "type": "mcp_approval_request", "id": key, "server_label": MCP_LABEL,
            "name": MCP_TOOL, "arguments": json.dumps({"q": words(1)})}]})
        if st != 200:
            raise AssertionError(f"(e) conversation: {st} {conv}")
        return conv["id"]

    answer = lambda key, yes: [{"type": "mcp_approval_response",  # noqa: E731
                                "approval_request_id": key, "approve": yes}]
    n0 = len(mcp.calls)
    cid = approval_conv("mcpr_smoke_yes")
    flush()
    st, body, e_ms = responses({"conversation": cid, "input": answer("mcpr_smoke_yes", True)})
    kinds = [o["type"] for o in body.get("output", [])]
    call = next((o for o in body.get("output", []) if o["type"] == "mcp_call"), {})
    expect(st == 200 and kinds == ["mcp_list_tools", "mcp_call", "message"], f"(e) {st} {kinds}")
    expect(len(mcp.calls) == n0 + 1, f"(e) the tool ran {len(mcp.calls) - n0} times")
    expect(call.get("error") is None and (call.get("output") or "").startswith("w4242"),
           f"(e) mcp_call {call}")
    # the model's turn saw the tool's answer: it equals a direct chat of it
    flush()
    st, direct, _ = chat([
        {"role": "assistant", "content": None, "tool_calls": [{
            "id": "mcpr_smoke_yes", "type": "function",
            "function": {"name": MCP_TOOL, "arguments": call.get("arguments", "{}")}}]},
        {"role": "tool", "content": call.get("output"), "tool_call_id": "mcpr_smoke_yes"}])
    expect(st == 200 and _output_text(body) == direct["choices"][0]["message"]["content"]
           and body["usage"]["input_tokens"] == direct["usage"]["prompt_tokens"],
           f"(e) the turn after the tool != a chat with its answer: {body['usage']} "
           f"{direct.get('usage')}")
    out["mcp_call_ms"] = next((ms for k, ms in reversed(spans) if k == "call_tool"), None)
    out["approval_turn_ms"] = e_ms
    cid_no = approval_conv("mcpr_smoke_no")
    st, body, _ = responses({"conversation": cid_no, "input": answer("mcpr_smoke_no", False)})
    call = next((o for o in body.get("output", []) if o["type"] == "mcp_call"), {})
    expect(st == 200 and call.get("error") == "approval denied by user"
           and len(mcp.calls) == n0 + 1, f"(e) denied: {st} {call} calls {len(mcp.calls) - n0}")
    st, body, _ = responses({"conversation": cid, "input": answer("mcpr_nope", True)})
    expect(st == 404 and "not found" in body["error"]["message"], f"(e) unknown key: {st} {body}")
    print(f"  (e) the approved MCP call took {out['mcp_call_ms']:.2f} ms from the handler's "
          f"call to the tool's answer; the approval turn {e_ms:.2f} ms ({card})")

    # (f) a request-level server whose label collides with a configured one
    st, body, _ = responses({"input": words(4), "tools": [{
        "type": "mcp", "server_label": MCP_LABEL, "server_url": "http://127.0.0.1:9/mcp"}]})
    expect(st == 400 and body["error"]["message"] ==
           f"mcp server_label {MCP_LABEL!r} collides with a gateway-configured server",
           f"(f) label collision: {st} {body}")
    return out


# ---- phase 16: the Anthropic Messages API, providers and per-model routers ----

MSG_NEW = 32  # output tokens of every phase-16 check request
MSG_TIMED_NEW = 16  # output tokens of every timed stream of (d)
MSG_REPS = 5  # timed repeats of (d), for the medians
FRONT_PROVIDERS = ("openai", "anthropic", "xai")  # the front's providers, by kind


def _provider_front(tmp: Path, upstream_port: int, model: str, plugin: Path) -> tuple:
    """Phase 16 (b)'s front: a ``launch`` process with no worker and a
    ``--provider-config`` of three providers (one of each kind in
    ``FRONT_PROVIDERS``, named after it) that all point at the gateway on
    ``upstream_port``, and phase 17 (e)'s ``plugin`` loaded fail-closed;
    returns (child, port, the configured model ids)."""
    base = f"http://127.0.0.1:{upstream_port}/v1"
    models = [f"{kind}/{model}" for kind in FRONT_PROVIDERS]
    (tmp / "providers.json").write_text(json.dumps([
        {"name": kind, "kind": kind, "base_url": base, "models": [m]}
        for kind, m in zip(FRONT_PROVIDERS, models)]))
    port = _free_port()
    child = Child("provider-front", [*CLI, "launch", "--host", "127.0.0.1", "--port", port,
                                     "--provider-config", tmp / "providers.json",
                                     "--plugins", plugin, "--plugin-fail-closed"])
    return child, port, models


def _sse_named(port: int, path: str, body: dict) -> tuple[int, list]:
    """A streamed request: (status, [(seconds since the send, event name or
    None, payload)]) for every ``data:`` frame, ``[DONE]`` as the string."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    frames, name = [], None
    with urllib.request.urlopen(req, timeout=LOOP_WAIT_S) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = line[len("data: "):]
                frames.append((time.perf_counter() - t0, name,
                               data if data == "[DONE]" else json.loads(data)))
                name = None
        return resp.status, frames


def _chat_frames_text(frames) -> str:
    return "".join(c["delta"].get("content") or "" for _t, _n, f in frames if f != "[DONE]"
                   for c in f.get("choices", []))


def _messages_text(body: dict) -> str:
    return "".join(b.get("text") or "" for b in body.get("content", []) if b["type"] == "text")


def _is_chat_content(name, payload) -> bool:
    return payload != "[DONE]" and any(c["delta"].get("content")
                                       for c in payload.get("choices", []))


def _is_text_delta(name, payload) -> bool:
    return name == "content_block_delta"


def _grammar_ok(names: list) -> bool:
    """The bridge's event grammar for one text block."""
    n = len(names) - 5
    return n > 0 and names == (["message_start", "content_block_start"]
                               + ["content_block_delta"] * n
                               + ["content_block_stop", "message_delta", "message_stop"])


def _bridge_timer(router_mod) -> tuple:
    """Wrap the bridge's three functions where the router calls them: each
    request's host ms inside them (a stream's own time between chunks, the
    chunks' wait taken out) lands in the returned list; the second value
    undoes the wrapping."""
    real = {k: getattr(router_mod, k) for k in (
        "anthropic_to_openai_request", "openai_to_anthropic_response",
        "openai_chunks_to_anthropic_events")}
    per_request: list = []
    pending = [0.0]

    def timed(fn, last: bool):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                pending[0] += (time.perf_counter() - t) * 1e3
                if last:
                    per_request.append(pending[0])
                    pending[0] = 0.0
        return run

    async def events(chunks, model):
        inner = [0.0]

        async def counted():
            it = chunks.__aiter__()
            while True:
                t = time.perf_counter()
                try:
                    c = await it.__anext__()
                except StopAsyncIteration:
                    inner[0] += time.perf_counter() - t
                    return
                inner[0] += time.perf_counter() - t
                yield c

        gen = real["openai_chunks_to_anthropic_events"](counted(), model)
        total = 0.0
        while True:
            t = time.perf_counter()
            try:
                item = await gen.__anext__()
            except StopAsyncIteration:
                total += time.perf_counter() - t
                break
            total += time.perf_counter() - t
            yield item
        per_request.append(pending[0] + (total - inner[0]) * 1e3)
        pending[0] = 0.0

    router_mod.anthropic_to_openai_request = timed(real["anthropic_to_openai_request"], False)
    router_mod.openai_to_anthropic_response = timed(real["openai_to_anthropic_response"], True)
    router_mod.openai_chunks_to_anthropic_events = events

    def undo():
        for k, fn in real.items():
            setattr(router_mod, k, fn)

    return per_request, undo


def _messages_checks(port, engine, model, front, L, expect, dev, card) -> dict:
    """Phase 16's checks (a)-(c) and readings (d) against the engine served
    on ``port`` (phase 15's gateway) under the model id ``model``, and the
    provider front ``front`` = (child, port, its model ids) in front of it;
    kernel launches counted over the whole phase."""
    import numpy as np
    import torch

    from smg_tpu_torch.gateway import router as router_mod
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    words = lambda n: _words(rng.integers(1000, 120000, n).tolist())  # noqa: E731
    child, fport, fmodels = front
    by_kind = dict(zip(FRONT_PROVIDERS, fmodels))
    out: dict = {}

    def flush():
        st, body = _http(port, "POST", "/flush_cache")
        if st != 200 or body["flushed"].get(SERVE_WORKER) is not True:
            raise AssertionError(f"/flush_cache: {st} {body}")

    def post(p, path, body):
        flush()  # every request from a cold radix cache (bf16 over a prefix rounds otherwise)
        return _http(p, "POST", path, body)

    def stream(p, path, body):
        flush()
        return _sse_named(p, path, body)

    system, turns = words(12), [words(60), words(20), words(40)]
    msgs = [{"role": r, "content": t} for r, t in zip(("user", "assistant", "user"), turns)]
    chat_msgs = [{"role": "system", "content": system}, *msgs]
    anth = {"model": model, "system": system, "messages": msgs, "max_tokens": MSG_NEW,
            "temperature": 0}

    def chat_body(m, messages=chat_msgs, **kw):
        return {"model": m, "messages": messages, "max_tokens": MSG_NEW, "temperature": 0, **kw}

    bridge_ms, undo = _bridge_timer(router_mod)
    for k in engine.runner.stats:
        engine.runner.stats[k] = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dk.launches = pk.launches = 0
    try:
        # (a) /v1/messages against chat on the same messages
        st, chat = post(port, "/v1/chat/completions", chat_body(model))
        expect(st == 200, f"(a) chat: {st} {chat}")
        want = chat["choices"][0]["message"]["content"]
        st, m = post(port, "/v1/messages", anth)
        expect(st == 200 and _messages_text(m) == want,
               f"(a) /v1/messages {st}: {_messages_text(m)!r} != chat {want!r}")
        expect(m.get("stop_reason") == "max_tokens"
               and m["usage"]["input_tokens"] == chat["usage"]["prompt_tokens"]
               and m["usage"]["output_tokens"] == chat["usage"]["completion_tokens"],
               f"(a) stop reason and usage: {m.get('stop_reason')} {m.get('usage')} "
               f"vs chat {chat['usage']}")
        st, ev = stream(port, "/v1/messages", {**anth, "stream": True})
        names = [n for _t, n, _p in ev]
        expect(st == 200 and _grammar_ok(names) and all(p["type"] == n for _t, n, p in ev),
               f"(a) the event grammar: {names}")
        joined = "".join(p["delta"]["text"] for _t, n, p in ev if n == "content_block_delta")
        expect(joined == want, f"(a) the text deltas {joined!r} != {want!r}")
        last = ev[-2][2] if len(ev) > 1 else {}
        expect(last.get("delta", {}).get("stop_reason") == "max_tokens"
               and last.get("usage") == {"input_tokens": chat["usage"]["prompt_tokens"],
                                         "output_tokens": chat["usage"]["completion_tokens"]},
               f"(a) message_delta {last}")
        print(f"  (a) /v1/messages equals the chat ({chat['usage']['prompt_tokens']} prompt "
              f"tokens, {len(ev)} events streamed)")

        # (b) the provider front, up since phase 15 began
        _wait_http_up(fport, child, "the provider front")
        st, listed = _http(fport, "GET", "/v1/models")
        expect(st == 200 and [d["id"] for d in listed["data"]] == fmodels,
               f"(b) the front's /v1/models: {st} {listed}")
        for kind, fm in by_kind.items():
            st, body = post(fport, "/v1/chat/completions", chat_body(fm))
            got = body["choices"][0]["message"]["content"] if st == 200 else body
            expect(st == 200 and got == want and body["model"] == fm,
                   f"(b) {kind} chat {st}: {got!r} != {want!r}")
            st, frames = stream(fport, "/v1/chat/completions", chat_body(fm, stream=True))
            n_content = sum(_is_chat_content(n, p) for _t, n, p in frames)
            expect(st == 200 and _chat_frames_text(frames) == want and n_content > 1
                   and frames[-1][2] == "[DONE]",
                   f"(b) {kind} chat streamed {st}: {_chat_frames_text(frames)!r} in "
                   f"{n_content} content frames")
        st, m = post(fport, "/v1/messages", {**anth, "model": by_kind["openai"]})
        expect(st == 200 and _messages_text(m) == want and m.get("stop_reason") == "max_tokens"
               and m["usage"]["input_tokens"] == chat["usage"]["prompt_tokens"],
               f"(b) /v1/messages over the openai provider {st}: {m}")
        st, ev = stream(fport, "/v1/messages", {**anth, "model": by_kind["openai"],
                                                "stream": True})
        joined = "".join(p["delta"]["text"] for _t, n, p in ev if n == "content_block_delta")
        expect(st == 200 and _grammar_ok([n for _t, n, _p in ev]) and joined == want
               and ev[-2][2]["usage"]["input_tokens"] == chat["usage"]["prompt_tokens"],
               f"(b) /v1/messages streamed over the openai provider: {joined!r} "
               f"{[n for _t, n, _p in ev]}")
        # /v1/responses: upstream through xai (the handler there adds the
        # configured MCP tool to its chat), over openai's chat without tools
        text_r = words(50)
        st, listed = post(port, "/v1/responses", {"model": model, "input": words(8),
                                                   "max_output_tokens": 1, "temperature": 0})
        tools = [{"type": "function", "function": {
            "name": t["name"], "description": t["description"], "parameters": t["input_schema"]}}
            for o in listed.get("output", []) if o["type"] == "mcp_list_tools" for t in o["tools"]]
        user = [{"role": "user", "content": text_r}]
        st, plain = post(port, "/v1/chat/completions", chat_body(model, user))
        st2, tooled = post(port, "/v1/chat/completions", chat_body(model, user, tools=tools))
        expect(st == st2 == 200 and tools, f"(b) the responses references: {st} {st2} {tools}")
        for kind, ref in (("xai", tooled), ("openai", plain)):
            st, body = post(fport, "/v1/responses", {
                "model": by_kind[kind], "input": text_r, "max_output_tokens": MSG_NEW,
                "temperature": 0})
            got = _output_text(body) if st == 200 else body
            ref_text = ref["choices"][0]["message"]["content"]
            expect(st == 200 and body["status"] == "completed" and got == ref_text,
                   f"(b) /v1/responses over {kind} {st}: {got!r} != {ref_text!r}")
        print(f"  (b) the front's three providers give the direct chat's text: chat and its "
              f"stream each, /v1/messages over the bridge, /v1/responses over xai and openai")

        # (c) a dedicated router for the model, then the default again
        st, before = _http(port, "GET", "/routers")
        st2, bad = _http(port, "POST", f"/models/{model}/router", {"config": {"no_such": 1}})
        st3, after = _http(port, "GET", "/routers")
        expect(st == st3 == 200 and st2 == 400 and "no_such" in str(bad) and after == before,
               f"(c) an unknown field: {st2} {bad}; /routers changed: {after != before}")
        st, desc = _http(port, "POST", f"/models/{model}/router",
                         {"config": {"default_max_tokens": MSG_NEW // 2}})
        expect(st == 200 and desc["dedicated_router"] and desc["workers"] == [SERVE_WORKER],
               f"(c) configure: {st} {desc}")
        st, body = post(port, "/v1/chat/completions", chat_body(model))
        got = body["choices"][0]["message"]["content"] if st == 200 else body
        expect(st == 200 and got == want, f"(c) the dedicated router's chat {got!r} != {want!r}")
        no_budget = {k: v for k, v in chat_body(model).items() if k != "max_tokens"}
        st, body = post(port, "/v1/chat/completions", {**no_budget, "ignore_eos": True})
        expect(st == 200 and body["usage"]["completion_tokens"] == MSG_NEW // 2,
               f"(c) the dedicated router's default budget: {st} {body.get('usage')}")
        st, listing = _http(port, "GET", "/routers")
        mine = [d for d in listing.get("models", []) if d["model_id"] == model]
        expect(st == 200 and mine and mine[0]["dedicated_router"], f"(c) /routers: {listing}")
        st, reset = _http(port, "DELETE", f"/models/{model}/router")
        st2, listing = _http(port, "GET", "/routers")
        mine = [d for d in listing.get("models", []) if d["model_id"] == model]
        expect(st == st2 == 200 and reset == {"model_id": model, "reset": True} and mine
               and not mine[0]["dedicated_router"], f"(c) DELETE: {reset} {listing}")
        print("  (c) a dedicated router served the same text and its own default budget; "
              "DELETE restored the default; an unknown field was a 400 that changed nothing")

        # (d) readings: lone TTFT and wall ms, medians of MSG_REPS, cold radix
        timed_chat = chat_body(model, stream=True, max_tokens=MSG_TIMED_NEW)
        timed_msgs = {**anth, "stream": True, "max_tokens": MSG_TIMED_NEW}
        routes = [("direct chat", port, "/v1/chat/completions", timed_chat, _is_chat_content),
                  ("/v1/messages", port, "/v1/messages", timed_msgs, _is_text_delta)]
        routes += [(f"{kind} hop, chat", fport, "/v1/chat/completions",
                    {**timed_chat, "model": fm}, _is_chat_content) for kind, fm in by_kind.items()]
        routes.append(("openai hop, /v1/messages", fport, "/v1/messages",
                       {**timed_msgs, "model": by_kind["openai"]}, _is_text_delta))
        n_bridge = len(bridge_ms)
        samples = {name: ([], []) for name, *_ in routes}
        for _rep in range(MSG_REPS):
            for name, p, path, body, first in routes:
                st, frames = stream(p, path, body)
                t_first = next((t for t, n, f in frames if first(n, f)), None)
                expect(st == 200 and t_first is not None, f"(d) {name}: {st}")
                samples[name][0].append((t_first or 0.0) * 1e3)
                samples[name][1].append(frames[-1][0] * 1e3 if frames else 0.0)
        out["ttft_ms"] = {k: statistics.median(v[0]) for k, v in samples.items()}
        out["wall_ms"] = {k: statistics.median(v[1]) for k, v in samples.items()}
        out["bridge_ms"] = statistics.median(bridge_ms) if bridge_ms else None
        out["bridge_ms_streamed"] = (statistics.median(bridge_ms[n_bridge:])
                                     if len(bridge_ms) > n_bridge else None)
        out["ttft_ms_all"] = {k: v[0] for k, v in samples.items()}
        print(f"  (d) lone TTFT / wall ms, {MSG_TIMED_NEW} new tokens, medians of {MSG_REPS} "
              f"(the TTFTs' range) ({card}): " + "; ".join(
                  f"{k} {out['ttft_ms'][k]:.2f} ({min(v[0]):.2f}-{max(v[0]):.2f}) / "
                  f"{out['wall_ms'][k]:.2f}" for k, v in samples.items()))
        print(f"  (d) the bridge's host ms per /v1/messages request on the engine's gateway "
              f"(median of {len(bridge_ms)}): {out['bridge_ms']:.3f}; streamed requests alone "
              f"{out['bridge_ms_streamed']:.3f}")
    finally:
        undo()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
    sched = {k: engine.runner.stats[k] for k in ("decode_columns", "prefill_calls")}
    want_l = {"decode_attention": L * sched["decode_columns"],
              "prefill_attention": L * sched["prefill_calls"]}
    expect(launches == want_l and min(launches.values()) > 0,
           f"phase 16 launches {launches} != {want_l} ({sched})")
    out["launches"], out["schedule"] = launches, sched
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 16: launches {launches} = {L} x {sched}; its checks took "
          f"{out['seconds']:.1f} s ({card})")
    return out


# ---- phase 17: the Realtime, Interactions and transcription APIs, plugins ----

RT_NEW = 16  # output tokens of every phase-17 turn and of its direct chat
RT_REPS = 5  # timed repeats of the readings, for the medians
RT_TIMEOUT_S = 1.0  # (c)'s --request-timeout-secs, shorter than its session
ASR_MODEL, ASR_WORKER = "whisper-smoke", "asr-smoke"
PLUGIN_HEADER = "x-smoke-plugin"
PLUGIN_NAME = "smoke_plugin"
# (e)'s plugin, written into a file phase 15's serve and phase 16's front
# load: it acts only on requests that carry PLUGIN_HEADER
SMOKE_PLUGIN = f'''"""The smoke plugin: ``{PLUGIN_HEADER}: reject`` is a 451, ``fault``
raises inside the hook, ``tag`` adds ``{PLUGIN_HEADER}-tag`` to the whole
response; a request without the header passes untouched."""

from smg_tpu_torch.plugins import Continue, Modify, Reject
from smg_tpu_torch.utils.logging import request_id_var

TAGGED = set()


async def on_request(req):
    what = req.headers.get("{PLUGIN_HEADER}")
    if what == "reject":
        return Reject(451, "rejected by the smoke plugin")
    if what == "fault":
        raise RuntimeError("the smoke plugin's fault")
    if what == "tag":
        TAGGED.add(req.request_id)
    return Continue()


async def on_response(resp):
    rid = request_id_var.get()  # the gateway sets it for every request
    if rid in TAGGED:
        TAGGED.discard(rid)
        return Modify(headers_set={{"{PLUGIN_HEADER}-tag": rid}})
    return Continue()
'''


def _smoke_plugin(tmp: Path) -> Path:
    path = tmp / f"{PLUGIN_NAME}.py"
    path.write_text(SMOKE_PLUGIN)
    return path


class AsrServer(LoopServer):
    """A loopback OpenAI-compatible audio worker: ``/v1/models``,
    ``/health`` and ``/v1/audio/transcriptions``, which answers
    ``transcript`` (plain text for ``response_format=text``, else JSON with
    the SHA-256 of the audio it received) and records each form's fields and
    its audio's SHA-256."""

    def __init__(self, transcript: str):
        self.transcript, self.forms = transcript, []
        super().__init__()

    def routes(self) -> list:
        return [("GET", "/v1/models", self.models), ("GET", "/health", self.models),
                ("POST", "/v1/audio/transcriptions", self.transcribe)]

    async def models(self, request):
        from aiohttp import web

        return web.json_response({"object": "list", "data": [{"id": ASR_MODEL}]})

    async def transcribe(self, request):
        import hashlib

        from aiohttp import web

        fields, digest = {}, None
        async for part in await request.multipart():
            if part.name == "file":
                digest = hashlib.sha256(await part.read(decode=False)).hexdigest()
            elif part.name:
                fields.setdefault(part.name, []).append((await part.read(decode=False)).decode())
        self.forms.append((fields, digest))
        if fields.get("response_format") == ["text"]:
            return web.Response(text=self.transcript, content_type="text/plain")
        return web.json_response({"text": self.transcript, "sha256": digest})


RT_UPDATE = {"type": "session.update", "session": {"temperature": 0, "max_output_tokens": RT_NEW}}


def _rt_item(text: str) -> dict:
    return {"type": "conversation.item.create",
            "item": {"role": "user", "content": [{"type": "input_text", "text": text}]}}


async def _rt_until(ws, last: tuple, t0: float | None = None) -> tuple[list, float | None]:
    """Events from ``ws`` up to one whose type is in ``last``, and the
    seconds from ``t0`` (default: the call) to the first
    ``response.output_text.delta``."""
    t0, first, out = time.perf_counter() if t0 is None else t0, None, []
    while True:
        ev = await ws.receive_json(timeout=LOOP_WAIT_S)
        if first is None and ev["type"] == "response.output_text.delta":
            first = time.perf_counter() - t0
        out.append(ev)
        if ev["type"] in last:
            return out, first


async def _rt_response(ws) -> tuple:
    """``response.create`` on ``ws``: (the text, the event types, the seconds
    to the first delta); the text is None unless the events are the
    reference's (``response.created``, deltas, ``response.done``) and the
    deltas join to ``response.done``'s text."""
    t0 = time.perf_counter()
    await ws.send_json({"type": "response.create"})
    events, first = await _rt_until(ws, ("response.done", "error"), t0)
    types = [e["type"] for e in events]
    deltas = [e["delta"] for e in events if e["type"] == "response.output_text.delta"]
    text = events[-1].get("response", {}).get("output_text")
    ok = (types[0] == "response.created" and types[-1] == "response.done" and deltas
          and set(types[1:-1]) == {"response.output_text.delta"} and "".join(deltas) == text)
    return (text if ok else None), types, first


async def _rt_open(http, url: str) -> tuple:
    """A realtime session on ``url`` with ``RT_UPDATE`` applied: (the
    websocket, ``session.created``, ``session.updated``)."""
    ws = await http.ws_connect(url)
    created = await ws.receive_json(timeout=LOOP_WAIT_S)
    await ws.send_json(RT_UPDATE)
    return ws, created, await ws.receive_json(timeout=LOOP_WAIT_S)


def _realtime_checks(port, held, model, front, L, expect, dev, card) -> dict:
    """Phase 17's checks (a)-(e) and readings against the engine served on
    ``port`` (phase 15's gateway: its context ``held["ctx"]``, served on the
    loop ``held["loop"]``) under the model id ``model``, and phase 16's
    provider front ``front`` = (child, port, its model ids); kernel launches
    counted over the whole phase."""
    import asyncio

    import torch

    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk

    t_phase = time.perf_counter()
    engine = held["ctx"].registry.get(SERVE_WORKER).client.engine
    host = held["ctx"].plugins
    expect(host is not None and [p.name for p in host.plugins] == [PLUGIN_NAME]
           and host.fail_open, f"(e) serve --plugins: {host and host.plugins}")
    hook_ms: dict = {"on_request": [], "on_response": []}

    def timed_hook(name, fn):
        async def run(arg):
            t = time.perf_counter()
            try:
                return await fn(arg)
            finally:
                hook_ms[name].append((time.perf_counter() - t) * 1e3)
        return run

    for k in hook_ms:
        setattr(host, k, timed_hook(k, getattr(host, k)))
    for k in engine.runner.stats:
        engine.runner.stats[k] = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dk.launches = pk.launches = 0
    asr = AsrServer(_words(range(2000, 2012)))
    try:
        out = asyncio.run(_realtime_drive(port, held, engine, model, front, asr, expect, card))
    finally:
        for k in hook_ms:
            delattr(host, k)  # the instance's wrapper goes; the class's method is back
        asr.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
    sched = {k: engine.runner.stats[k] for k in ("decode_columns", "prefill_calls")}
    want_l = {"decode_attention": L * sched["decode_columns"],
              "prefill_attention": L * sched["prefill_calls"]}
    expect(launches == want_l and min(launches.values()) > 0,
           f"phase 17 launches {launches} != {want_l} ({sched})")
    out["launches"], out["schedule"] = launches, sched
    out["plugin_ms"] = {k: statistics.median(v) if v else None for k, v in hook_ms.items()}
    out["plugin_calls"] = {k: len(v) for k, v in hook_ms.items()}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  (e) the plugin host's ms per request on the engine's gateway (medians of "
          f"{out['plugin_calls']} calls) ({card}): on_request {out['plugin_ms']['on_request']:.3f},"
          f" on_response {out['plugin_ms']['on_response']:.3f}")
    print(f"  phase 17: launches {launches} = {L} x {sched}; it took {out['seconds']:.1f} s "
          f"({card})")
    return out


async def _realtime_drive(port, held, engine, model, front, asr, expect, card) -> dict:
    """Phase 17's requests, from one aiohttp client session on this loop."""
    import asyncio
    import base64
    import hashlib

    import aiohttp
    import numpy as np
    from aiohttp import web

    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import build_context, gateway_options
    from smg_tpu_torch.gateway.realtime import pcm16_to_wav
    from smg_tpu_torch.gateway.server import build_app

    rng = np.random.default_rng(17)
    words = lambda n: _words(rng.integers(1000, 120000, n).tolist())  # noqa: E731
    url = f"http://127.0.0.1:{port}"
    rt_url = f"ws://127.0.0.1:{port}/v1/realtime"
    out: dict = {}

    def flush():
        st, body = _http(port, "POST", "/flush_cache")
        if st != 200 or body["flushed"].get(SERVE_WORKER) is not True:
            raise AssertionError(f"/flush_cache: {st} {body}")

    def chat_body(messages, m=model, **kw):
        return {"model": m, "messages": messages, "max_tokens": RT_NEW, "temperature": 0, **kw}

    def chat_text(messages) -> str | None:
        flush()  # every request from a cold radix cache (bf16 over a prefix rounds otherwise)
        st, body = _http(port, "POST", "/v1/chat/completions", chat_body(messages))
        expect(st == 200, f"the direct chat: {st} {body}")
        return body["choices"][0]["message"]["content"] if st == 200 else None

    async with aiohttp.ClientSession() as http:
        # (a) two text turns over the engine, an unknown event between them
        ws, created, updated = await _rt_open(http, f"{rt_url}?model={model}")
        expect(created["type"] == "session.created" and updated["type"] == "session.updated"
               and updated["session"]["temperature"] == 0
               and updated["session"]["max_output_tokens"] == RT_NEW,
               f"(a) the session: {created} {updated}")
        history, texts = [], []
        for turn, user in enumerate((words(40), words(20))):
            await ws.send_json(_rt_item(user))
            item = await ws.receive_json(timeout=LOOP_WAIT_S)
            expect(item["type"] == "conversation.item.created" and item["item"]["role"] == "user",
                   f"(a) turn {turn + 1}'s item: {item}")
            history.append({"role": "user", "content": user})
            flush()
            text, types, _first = await _rt_response(ws)
            expect(text is not None, f"(a) turn {turn + 1}'s events: {types}")
            want = chat_text(history)
            expect(text == want, f"(a) turn {turn + 1}: realtime {text!r} != chat {want!r}")
            texts.append(text)
            history.append({"role": "assistant", "content": text or ""})
            if turn == 0:
                await ws.send_json({"type": "smoke.no_such_event"})
                err = await ws.receive_json(timeout=LOOP_WAIT_S)
                expect(err == {"type": "error", "error": {
                    "message": "unknown event type 'smoke.no_such_event'"}},
                    f"(a) an unknown event: {err}")
        await ws.close()
        print(f"  (a) two realtime turns equal the direct chats on the same history "
              f"({len(history[0]['content'].split())}-word first turn, {RT_NEW} tokens each); "
              "an unknown event got the error event and the session went on")

        # (b) audio: PCM16 frames through the transcription leg, then
        # /v1/audio/transcriptions, both to a loopback ASR worker
        st, reg = _http(port, "POST", "/workers", {
            "url": f"http://127.0.0.1:{asr.port}", "model_id": ASR_MODEL,
            "worker_id": ASR_WORKER})
        expect(st == 200 and reg["added"]["worker_id"] == ASR_WORKER,
               f"(b) POST /workers: {st} {reg}")
        frames = [rng.integers(-8000, 8000, 1600).astype("<i2").tobytes() for _ in range(3)]
        wav = pcm16_to_wav(b"".join(frames))
        digest = hashlib.sha256(wav).hexdigest()
        # the default model: the transcription leg finds the ASR worker among
        # all workers, the response the engine (the only token-level worker)
        ws, _created, _updated = await _rt_open(http, rt_url)
        appended = []
        for f in frames:
            await ws.send_json({"type": "input_audio_buffer.append",
                                "audio": base64.b64encode(f).decode()})
            appended.append(await ws.receive_json(timeout=LOOP_WAIT_S))
        n_forms = len(asr.forms)
        await ws.send_json({"type": "input_audio_buffer.commit"})
        events, _ = await _rt_until(ws, ("conversation.item.input_audio_transcription.completed",
                                         "error"))
        expect([e.get("bytes") for e in appended] == [3200, 6400, 9600]
               and [e["type"] for e in events] == [
                   "input_audio_buffer.committed",
                   "conversation.item.input_audio_transcription.completed"]
               and events[-1]["transcript"] == asr.transcript,
               f"(b) append and commit: {appended} {events}")
        expect(asr.forms[n_forms:] == [({"model": ["default"]}, digest)],
               f"(b) the ASR worker got {asr.forms[n_forms:]}, not the frames' WAV {digest}")
        flush()
        text, types, _first = await _rt_response(ws)
        want = chat_text([{"role": "user", "content": asr.transcript}])
        expect(text is not None and text == want,
               f"(b) the response on the transcript {text!r} ({types}) != chat {want!r}")
        await ws.close()
        transcriptions = []
        for fmt in ("json", "text"):
            form = aiohttp.FormData()
            for name, value in (("model", ASR_MODEL), ("response_format", fmt),
                                ("timestamp_granularities[]", "word"),
                                ("timestamp_granularities[]", "segment")):
                form.add_field(name, value)
            form.add_field("file", wav, filename="smoke.wav", content_type="audio/wav")
            async with http.post(f"{url}/v1/audio/transcriptions", data=form) as r:
                transcriptions.append((r.status, r.content_type, await r.text()))
        sent = [f for f, _d in asr.forms[-2:]]
        expect(transcriptions[0][:2] == (200, "application/json")
               and json.loads(transcriptions[0][2]) == {"text": asr.transcript, "sha256": digest}
               and transcriptions[1] == (200, "text/plain", asr.transcript)
               and all(f["timestamp_granularities[]"] == ["word", "segment"] for f in sent)
               and [d for _f, d in asr.forms[-2:]] == [digest, digest],
               f"(b) /v1/audio/transcriptions: {transcriptions} {sent}")
        st, gone = _http(port, "DELETE", f"/workers/{ASR_WORKER}?drain=0")
        expect(st == 200, f"(b) DELETE /workers/{ASR_WORKER}: {st} {gone}")
        print(f"  (b) {len(frames)} PCM16 frames reached the ASR worker as one WAV (sha256 "
              f"{digest[:12]}); the response on its transcript equals the chat; "
              "/v1/audio/transcriptions json and text with two granularities")

        # (c) client secrets, the relay and the timeout exemption on an extra
        # gateway over the same engine, with an API key and a short timeout
        args = build_parser().parse_args([
            "serve", "--model-preset", model, "--api-key", f"{API_KEY}:smoke",
            "--request-timeout-secs", str(RT_TIMEOUT_S)])
        ctx2 = build_context(engine, **gateway_options(args))
        port2 = _free_port()
        auth = {"Authorization": f"Bearer {API_KEY}"}

        async def start():
            runner = web.AppRunner(build_app(ctx2))
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", port2).start()
            return runner

        runner2 = await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(start(), held["loop"]))
        try:
            rt2 = f"ws://127.0.0.1:{port2}/v1/realtime"
            ws = await http.ws_connect(f"{rt2}?model={model}")
            denied = await ws.receive_json(timeout=LOOP_WAIT_S)
            await ws.close()
            async with http.post(f"http://127.0.0.1:{port2}/v1/realtime/client_secrets") as r:
                unauth = r.status
            async with http.post(f"http://127.0.0.1:{port2}/v1/realtime/client_secrets",
                                 headers=auth) as r:
                minted = (r.status, await r.json())
            expect(denied["type"] == "error"
                   and denied["error"]["type"] == "authentication_error" and unauth == 401
                   and minted[0] == 200 and minted[1]["client_secret"]["value"].startswith("eph_"),
                   f"(c) the handshake without a credential {denied}, minting {unauth} {minted}")
            secret = minted[1]["client_secret"]["value"]
            payload = rng.bytes(64 * 1024)
            offer = json.dumps({"type": "offer", "sdp": words(8)})

            async def session():
                t0 = time.perf_counter()
                ws, created, _ = await _rt_open(http, f"{rt2}?model={model}&client_secret={secret}")
                await asyncio.sleep(1.5 * RT_TIMEOUT_S)
                await ws.send_json(_rt_item(history[0]["content"]))
                await ws.receive_json(timeout=LOOP_WAIT_S)
                flush()
                text, types, _first = await _rt_response(ws)
                await ws.close()
                return created["type"], text, types, time.perf_counter() - t0

            async def relay():
                leg = f"ws://127.0.0.1:{port2}/v1/realtime/relay/smoke17?client_secret={secret}"
                a = await http.ws_connect(f"{leg}&leg=a")
                joined = [await a.receive_json(timeout=LOOP_WAIT_S)]
                b = await http.ws_connect(f"{leg}&leg=b")
                joined += [await b.receive_json(timeout=LOOP_WAIT_S),
                           await a.receive_json(timeout=LOOP_WAIT_S)]
                await asyncio.sleep(1.5 * RT_TIMEOUT_S)
                await a.send_str(offer)
                got_text = await b.receive_str(timeout=LOOP_WAIT_S)
                await b.send_bytes(payload)
                got_bin = await a.receive(timeout=LOOP_WAIT_S)
                await b.close()
                joined.append(await a.receive_json(timeout=LOOP_WAIT_S))
                await a.close()
                return joined, got_text, got_bin

            (created, text_c, types_c, secs), (joined, got_text, got_bin) = \
                await asyncio.gather(session(), relay())
            expect(created == "session.created" and text_c == texts[0] and secs > RT_TIMEOUT_S,
                   f"(c) the session over ?client_secret= for {secs:.2f} s (timeout "
                   f"{RT_TIMEOUT_S} s): {text_c!r} ({types_c}) != (a)'s {texts[0]!r}")
            expect([j["type"] for j in joined] == ["relay.joined", "relay.joined",
                                                   "relay.peer_connected",
                                                   "relay.peer_disconnected"]
                   and got_text == offer and got_bin.type == aiohttp.WSMsgType.BINARY
                   and got_bin.data == payload,
                   f"(c) the relay: {joined}, text equal {got_text == offer}, binary "
                   f"{got_bin.type} equal {got_bin.data == payload}")
            t0 = time.perf_counter()
            st, body = _http(port2, "POST", "/v1/chat/completions", chat_body(
                [{"role": "user", "content": words(20)}], max_tokens=1024, ignore_eos=True),
                headers=auth)
            cut_s = time.perf_counter() - t0
            expect(st == 408 and RT_TIMEOUT_S <= cut_s < RT_TIMEOUT_S + 2.0,
                   f"(c) a chat past the timeout: {st} after {cut_s:.2f} s: {body}")
            deadline = time.monotonic() + 60
            while engine.has_work() and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            expect(not engine.has_work(), "(c) the timed-out chat still runs in the engine")
        finally:
            await asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(runner2.cleanup(), held["loop"]))
            for w in ctx2.registry.list():  # the engine stays: its client is not closed
                ctx2.registry.remove(w.worker_id)
        print(f"  (c) a minted client secret opened a session that outlived the "
              f"{RT_TIMEOUT_S} s timeout ({secs:.2f} s) and answered (a)'s first turn; the "
              f"relay legs exchanged a text and a 64 KiB binary frame byte for byte; a chat "
              f"got its 408 after {cut_s:.2f} s")

        # (d) interactions: a stored turn, a chained turn, the chained turn
        # streamed, get, delete, and a Responses id that is not one
        system, i_user1, i_user2 = words(8), words(40), words(20)
        gen = {"temperature": 0, "max_output_tokens": RT_NEW}
        first = {"model": model, "input": i_user1, "system_instruction": system,
                 "generation_config": gen}
        flush()
        st, i1 = _http(port, "POST", "/v1/interactions", first)
        m1 = [{"role": "system", "content": system}, {"role": "user", "content": i_user1}]
        t1 = _interaction_text(i1) if st == 200 else None
        want = chat_text(m1)
        expect(st == 200 and t1 == want, f"(d) turn 1 {st}: {t1!r} != chat {want!r}")
        second = {"model": model, "input": i_user2, "previous_interaction_id": i1.get("id"),
                  "generation_config": gen}
        flush()
        st, i2 = _http(port, "POST", "/v1/interactions", second)
        t2 = _interaction_text(i2) if st == 200 else None
        want = chat_text(m1 + [{"role": "assistant", "content": t1 or ""},
                               {"role": "user", "content": i_user2}])
        expect(st == 200 and t2 == want and i2.get("previous_interaction_id") == i1.get("id"),
               f"(d) the chained turn {st}: {t2!r} != chat {want!r}")
        flush()
        st, frames = _sse_named(port, "/v1/interactions", {**second, "stream": True})
        payloads = [p for _t, _n, p in frames]
        deltas = "".join(p["delta"]["text"] for p in payloads[:-1] if p["type"] == "content_delta")
        done = [p for p in payloads[:-1] if p["type"] == "interaction_complete"]
        expect(st == 200 and payloads[-1] == "[DONE]" and deltas == t2 and done
               and _interaction_text(done[0]["interaction"]) == t2,
               f"(d) the streamed turn {st}: {deltas!r} != {t2!r}")
        st_get, got = _http(port, "GET", f"/v1/interactions/{i2.get('id')}")
        st_del, deleted = _http(port, "DELETE", f"/v1/interactions/{i2.get('id')}")
        st_gone, _gone = _http(port, "GET", f"/v1/interactions/{i2.get('id')}")
        st_r, resp = _http(port, "POST", "/v1/responses", {
            "model": model, "input": words(8), "max_output_tokens": 1, "temperature": 0})
        st_not, _not = _http(port, "GET", f"/v1/interactions/{resp.get('id')}")
        expect(st_get == 200 and got["id"] == i2["id"] and got["outputs"] == i2["outputs"]
               and (st_del, deleted) == (200, {"deleted": i2["id"]}) and st_gone == 404
               and st_r == 200 and st_not == 404,
               f"(d) get {st_get}, delete {st_del} {deleted}, get after {st_gone}, a "
               f"/v1/responses id {st_r} -> {st_not}")
        print("  (d) a stored and a chained interaction equal the direct chats, the "
              "streamed chained turn's deltas join to its text; get, delete, 404 after, "
              "and a /v1/responses id is 404")

        # (e) the plugin on phase 15's gateway (fail-open) and the front's
        # (fail-closed); without the header the phases before saw no change
        child, fport, fmodels = front
        _wait_http_up(fport, child, "the provider front")
        plain = [{"role": "user", "content": words(30)}]
        want = chat_text(plain)
        seen = {}
        for where, p, m in (("serve", port, model), ("front", fport, fmodels[0])):
            for what in ("reject", "tag", "fault", None):
                flush()
                headers = {PLUGIN_HEADER: what} if what else {}
                async with http.post(f"http://127.0.0.1:{p}/v1/chat/completions",
                                     json=chat_body(plain, m), headers=headers) as r:
                    seen[where, what] = (r.status, r.headers.get(f"{PLUGIN_HEADER}-tag"),
                                         await r.json())
        for (where, what), (st, tag, body) in seen.items():
            text = body["choices"][0]["message"]["content"] if st == 200 else None
            err = body.get("error", {})
            if what == "reject":
                ok = (st == 451 and err.get("type") == "plugin_rejected"
                      and err.get("message") == "rejected by the smoke plugin")
            elif what == "fault" and where == "front":
                ok = (st == 500 and err.get("type") == "plugin_rejected"
                      and err.get("message") == f"plugin {PLUGIN_NAME} failed")
            else:
                ok = st == 200 and text == want and (tag is not None) == (what == "tag")
            expect(ok, f"(e) {where} with {what}: {st} tag {tag} {body}")
        print("  (e) the plugin: reject 451 on both, tag's header back with the same text, "
              "fault served fail-open by serve and 500 by the fail-closed front; no header, "
              "no change")

        # readings: realtime TTFT against the direct chat's, an interactions
        # turn's wall time against its chat's; medians of RT_REPS, cold radix
        user = words(40)
        samples: dict = {k: [] for k in ("rt_ttft", "chat_ttft", "int_wall", "chat_wall")}
        for _rep in range(RT_REPS):
            ws, _c, _u = await _rt_open(http, f"{rt_url}?model={model}")
            await ws.send_json(_rt_item(user))
            await ws.receive_json(timeout=LOOP_WAIT_S)
            flush()
            text, _types, first_s = await _rt_response(ws)
            await ws.close()
            flush()
            st, frames = _sse_named(port, "/v1/chat/completions",
                                    chat_body([{"role": "user", "content": user}], stream=True))
            t_first = next((t for t, n, f in frames if _is_chat_content(n, f)), None)
            expect(text is not None and first_s is not None and st == 200 and t_first,
                   f"(readings) realtime {text!r}, chat {st}")
            samples["rt_ttft"].append((first_s or 0.0) * 1e3)
            samples["chat_ttft"].append((t_first or 0.0) * 1e3)
            flush()
            st, _b, ms = _timed_http(port, "POST", "/v1/interactions", {**first, "store": False})
            flush()
            st2, _b2, ms2 = _timed_http(port, "POST", "/v1/chat/completions", chat_body(m1))
            expect(st == st2 == 200, f"(readings) interactions {st}, chat {st2}")
            samples["int_wall"].append(ms)
            samples["chat_wall"].append(ms2)
    out.update({k: statistics.median(v) for k, v in samples.items()})
    out["samples"] = samples
    print(f"  readings, medians of {RT_REPS} ({card}): realtime TTFT {out['rt_ttft']:.2f} ms "
          f"(range {min(samples['rt_ttft']):.2f}-{max(samples['rt_ttft']):.2f}) against the "
          f"direct chat's {out['chat_ttft']:.2f} ms; an interactions turn {out['int_wall']:.2f} "
          f"ms wall against its chat's {out['chat_wall']:.2f} ms ({RT_NEW} tokens)")
    return out


def _interaction_text(body: dict) -> str:
    return "".join(p.get("text") or "" for o in body.get("outputs", [])
                   for p in o.get("parts", []) if isinstance(p, dict))


def phase_engine(dev, card: str, side: "SideWorker", worker_cli: dict | None = None) -> dict:
    """Phases 3-8, 10, 13, the float32 repeat and the preemption check on
    Llama-3-8B; ``side`` writes phase 8's files meanwhile, ``worker_cli``
    is phase 13's CLI check if it ran already."""
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params

    from smg_tpu_torch.analysis import lock_order_sentinel

    cfg = llama3_8b_config()
    L, max_new = cfg.num_layers, 32
    # the serving configuration: bf16 weights and KV.  Every engine of phase
    # 3 is built under the lock-order sentinel (its exit raises on any
    # inversion); the serving path's engine also runs the guarded window
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # phase 8's files (the checkpoint of these weights, its adapters, the
    # float32 repeat's) are written by a process of their own meanwhile
    root = Path(tempfile.mkdtemp(prefix="smg_ckpt_"))
    writer = side.submit(write_ckpt_files, dataclasses.asdict(cfg), params, str(root))
    try:
        with lock_order_sentinel() as sentinel:
            runs = serve_paths(cfg, params, dev, max_new, with_profile=True,
                               after=lambda label, eng: (
                                   guarded_decode(eng, dev, card) if label == "graphs"
                                   else None))
        print(f"  phase 3: {len(sentinel.inversions)} lock-order inversions over its engines")
        agree = check_runs(runs, L, max_new, "bf16")
        out = {"bf16": summarize(runs, card, "bf16"), "bf16_agreement": agree}
        out["decode_profile"] = {k: r["profile"] for k, r in runs.items()}
        out["guarded"] = runs["graphs"]["after"]
        out["guarded"]["profile_wall_ms_per_column"] = runs["graphs"]["profile"][
            "wall_ms_per_column"]
        out["lock_inversions_phase3"] = len(sentinel.inversions)
        print(f"  phase 3 decode: guarded window {out['guarded']['guarded_ms_per_column']:.3f} "
              f"ms/column, unguarded {out['guarded']['unguarded_ms_per_column']:.3f}, the "
              f"profiled window {out['guarded']['profile_wall_ms_per_column']:.3f} ({card})")
        out["launches"] = runs["graphs"]["launches"]
        out["schedule"] = runs["graphs"]["stats"]
        # phases 4 and 7 in bf16 on the first BF16_REPEAT_LAYERS layers of the
        # same weights: their checks hold at any depth
        n = BF16_REPEAT_LAYERS
        cfg_n = dataclasses.replace(cfg, num_layers=n)
        cut = {**params, "layers": {k: v[:n] for k, v in params["layers"].items()}}
        # phase 4: penalties, stop strings and grammars through every path, with
        # the synthetic tokenizer at the full vocabulary
        print(f"phase 4: request semantics, bf16 (the first {n} layers)")
        tok = PieceTokenizer(cfg.vocab_size, (cfg.bos_token_id, *cfg.eos_token_ids))
        rq = request_paths(cfg_n, cut, dev, tok, "bf16", {}, with_profile=True)
        out["requests_bf16"] = check_requests(rq, n, "bf16", card, strict=False)
        del rq
        torch.cuda.empty_cache()
        # phase 5 on the same weights: the serving entry over HTTP
        print("phase 5: serving entry over HTTP, bf16")
        out["serve_bf16"] = phase_serve(cfg, params, dev, card, "bf16", strict=False)
        print("phase 6: the request-policy layer over HTTP, bf16")
        out["policy_bf16"] = phase_policy(cfg, params, dev, card, "bf16", strict=False,
                                          bare=out["serve_bf16"])
        print(f"phase 7: speculative decoding, bf16 (the first {n} layers)")
        out["spec_bf16"] = phase_spec(cfg_n, cut, dev, card, "bf16", strict=False)
        del cut
        # phase 8: the same bf16 weights written as an HF checkpoint directory
        ckpt8 = writer.result()
        torch.cuda.ipc_collect()
        cfg8 = dataclasses.replace(cfg, num_layers=ckpt8["layers"])
        params8 = {**params, "layers": {k: v[:ckpt8["layers"]]
                                        for k, v in params["layers"].items()}}
        print(f"  phase 8's files were written beside phases 3-7 (the result read "
              f"{writer.waited_s:.1f} s after the writer started)")
        out["ckpt_files"] = ckpt8
        print("phase 8: serve --model-path, the HF tokenizer and LoRA, bf16")
        out["ckpt_bf16"] = phase_checkpoint(cfg8, params8, dev, card, "bf16", strict=False,
                                            ckpt=root / CKPT_MODEL, adapters=ckpt8["adapters"],
                                            tiny=root / "tiny")
        del params8
        torch.cuda.empty_cache()
        print("phase 10: the rest of serve; embeddings, rerank and classify, bf16")
        out["api_bf16"] = phase_api(cfg, params, dev, card, "bf16", strict=False,
                                    stall_free=runs["graphs"], sink={})
        del runs
        print("phase 13: PD disaggregation (float32 at 4 layers, bf16 at full depth, gRPC "
              "workers)")
        out["pd"] = phase_pd(cfg, params, dev, card,
                             phase3_decode_ms=out["decode_profile"]["graphs"].get(
                                 "device_ms_per_column"), worker_cli=worker_cli)
        out.update(_phases_f32(cfg, params, dev, card, root,
                               adapters=ckpt8["f32_adapters"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    params.clear()  # the last phase on these weights: give the card back
    torch.cuda.empty_cache()
    out["preemption"] = phase_preempt(dev)
    return out


def prepare_checkpoint(cfg, params, root: Path) -> tuple:
    """Phase 8's files under ``root``: the checkpoint of ``params`` (bf16)
    as ``CKPT_MODEL``, two PEFT adapters and the tiny directory.  A disk
    that cannot hold every layer cuts the checkpoint's depth (never its
    width); returns (what was written, the checkpoint's config, its
    weights: ``params`` cut to that depth)."""
    import dataclasses

    free = shutil.disk_usage(root).free
    per_layer = sum(t[0].numel() * t.element_size() for t in params["layers"].values())
    other = sum(params[k].numel() * params[k].element_size() for k in params if k != "layers")
    margin = 4 << 30  # the tiny directory, the adapters and headroom
    layers = int(min(cfg.num_layers, max(1, (free - other - margin) // per_layer)))
    cfg8 = dataclasses.replace(cfg, num_layers=layers)
    params8 = {**params, "layers": {k: v[:layers] for k, v in params["layers"].items()}}
    written = write_checkpoint(cfg8, params8, root / CKPT_MODEL, CKPT_SHARDS)
    adapters = {}
    for i, name in enumerate(("a", "b")):
        write_peft(cfg8, root / f"adapter_{name}", seed=100 + i)
        adapters[name] = str(root / f"adapter_{name}")
    write_tiny_dir(root / "tiny", cfg.vocab_size)
    written.update(disk_free_bytes=free, layers=layers, depth_cut=layers < cfg.num_layers,
                   adapters=adapters)
    print(f"  checkpoint: {written['file_bytes']} bytes in {CKPT_SHARDS} files, "
          f"{layers} of {cfg.num_layers} layers (disk free {free} bytes), written in "
          f"{written['write_s']:.1f} s; adapters {sorted(adapters)} (rank {LORA_RANK})")
    return written, cfg8, params8


def write_f32_files(cfg, params, f32_root: Path) -> dict:
    """The float32 repeat's phase-8 files: the checkpoint of the first
    ``F32_LAYERS`` layers of ``params`` (bf16, widened as they load) and its
    two adapters; returns the adapters' paths."""
    import dataclasses

    cut = {**params, "layers": {k: v[:F32_LAYERS] for k, v in params["layers"].items()}}
    cfg_n = dataclasses.replace(cfg, num_layers=F32_LAYERS)
    write_checkpoint(cfg_n, cut, f32_root / CKPT_MODEL, CKPT_SHARDS)
    adapters = {}
    for i, name in enumerate(("a", "b")):
        write_peft(cfg_n, f32_root / f"adapter_{name}", seed=100 + i)
        adapters[name] = str(f32_root / f"adapter_{name}")
    return adapters


def write_ckpt_files(config: dict, params: dict, root: str) -> dict:
    """Phase 8's files for both dtypes (``prepare_checkpoint``,
    ``write_f32_files``) under ``root``, from ``params`` (bf16)."""
    from smg_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(**config)
    written, _cfg8, _params8 = prepare_checkpoint(cfg, params, Path(root))
    written["f32_adapters"] = write_f32_files(cfg, params, Path(root) / "f32")
    return written


def _side_main(tasks, results) -> None:
    """The side worker's loop: run each ``(fn, args)`` from ``tasks``, put
    ``("ok", value)`` or ``("error", traceback)`` on ``results``."""
    import torch

    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")  # its CUDA context, before any phase sizes KV
    while True:
        task = tasks.get()
        if task is None:
            return
        fn, args = task
        try:
            results.put(("ok", fn(*args)))
        except BaseException:
            results.put(("error", traceback.format_exc()))
        del task, fn, args  # the shared tensors go back to their owner


class SideWorker:
    """A process of its own (``spawn``), started with the script, that runs
    tasks beside the phases: it writes the checkpoints phases 8 and 9 (d)
    serve while the phases before them run (phase 8's 16 GB took 23.4 s of
    a 930 s run when phase 8 waited for it; NVIDIA H100 80GB HBM3, 700 W).
    CUDA tensors in a task's arguments are shared with it on the card (CUDA
    IPC: nothing is copied there; the owner keeps them alive until the
    task's ``result``).  Its CUDA context exists before any phase sizes a KV
    cache from the free memory.  One task at a time."""

    def __init__(self):
        import torch.multiprocessing as tmp

        ctx = tmp.get_context("spawn")
        self.tasks, self.results = ctx.SimpleQueue(), ctx.SimpleQueue()
        self.proc = ctx.Process(target=_side_main, args=(self.tasks, self.results),
                                name="side-worker", daemon=True)
        self.proc.start()
        self.name, self.t0, self.waited_s = None, 0.0, 0.0

    def submit(self, fn, *args) -> "SideWorker":
        self.name, self.t0 = fn.__name__, time.perf_counter()
        self.tasks.put((fn, args))
        return self

    def result(self, timeout: float = LOOP_WAIT_S):
        """The task's value (waiting for it); raises if it failed."""
        deadline = time.monotonic() + timeout
        while self.results.empty():
            if not self.proc.is_alive():
                raise AssertionError(f"the side worker exited {self.proc.exitcode} in "
                                     f"{self.name}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.name} took over {timeout} s")
            time.sleep(0.1)
        status, value = self.results.get()
        self.waited_s = time.perf_counter() - self.t0
        if status != "ok":
            raise AssertionError(f"{self.name} failed:\n{value}")
        return value

    def close(self) -> None:
        if self.proc.is_alive():
            self.tasks.put(None)
            self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)


F32_LAYERS = 4  # the float32 repeat's depth: its checks are exact at any depth
# the bf16 depth of phases 4 and 7, whose checks (finishes, stop text,
# grammars, drafting, launches, audits) hold at any depth: at all 32 layers
# they took 43 and 58 s of a 914 s run (H100 80GB HBM3, 700 W), time the
# deadline needs on slower card hosts
BF16_REPEAT_LAYERS = 8


def _phases_f32(cfg, params, dev, card: str, root: Path, adapters: dict) -> dict:
    """Phases 3-5, 7, 8 and 10 again on the first ``F32_LAYERS`` layers
    of the same weights widened to float32 (the width stays whole): the
    three paths there differ only in summation order, so their streams
    must be identical.  The bf16 references of the two checks across
    dtypes are made at the same depth first: phase 3's three paths
    (first-token logits) and phase 10's embeddings; phase 8 serves a
    checkpoint of that depth written under ``root`` beside the earlier
    phases, with ``adapters``, its adapters' paths.  Then phase 6 on all
    of ``params``, widened in place (phase 5's bare gateway reading beside
    it is the ``F32_LAYERS``-layer one)."""
    import dataclasses

    import torch

    from smg_tpu_torch.tokenizer import MockTokenizer

    out = {}
    N, max_new = F32_LAYERS, 32
    cfg_n = dataclasses.replace(cfg, num_layers=N)
    cut = {**params, "layers": {k: v[:N] for k, v in params["layers"].items()}}
    print(f"phase 3: the first {N} layers in bf16, the reference of the float32 repeat")
    runs16 = serve_paths(cfg_n, cut, dev, max_new)
    out["bf16_cut_agreement"] = check_runs(runs16, N, max_new, f"bf16 {N} layers")
    jobs = _api_jobs(10)
    mock = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                         bos_token_id=cfg.bos_token_id)
    engine = _api_engine(cfg_n, cut, dev, mock, 2048)
    sink = {"embed_bf16": {"texts": engine.embed([mock.encode(t) for t in jobs["texts"]]),
                           "ids": engine.embed(jobs["id_lists"])}}
    engine.stop()
    del engine
    f32_root = root / "f32"
    # the same requests on the same weights widened to float32, with float32
    # KV: the three paths differ only in summation order, so the logits
    # agree tightly and the greedy streams match
    tok = PieceTokenizer(cfg.vocab_size, (cfg.bos_token_id, *cfg.eos_token_ids))
    params32 = {**cut, "layers": dict(cut["layers"])}
    _widen(params32)
    cfg32 = dataclasses.replace(cfg_n, dtype="float32")
    runs32 = serve_paths(cfg32, params32, dev, max_new)
    agree32 = check_runs(runs32, N, max_new, "f32")
    out["f32"] = summarize(runs32, card, "f32")
    out["f32_agreement"] = agree32
    n = len(runs32["plain"]["results"])
    if agree32["streams_equal"] != {k: n for k in agree32["streams_equal"]} or \
            max(agree32["logit_gap"].values()) > F32_LOGIT_ATOL:
        raise AssertionError(f"f32 paths disagree: {agree32}")
    # the float32 plain run is the reference for the bf16 runs of its depth
    ref = runs32["plain"]["logits"]
    err = {name: max(float((a - b).abs().max()) for a, b in zip(runs16[name]["logits"], ref))
           for name in runs16}
    print(f"  [bf16, {N} layers] first-token logits against the f32 run: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in err.items()))
    if not max(err["graphs"], err["eager"]) <= BF16_ERR_RATIO * err["plain"]:
        raise AssertionError(f"bf16 kernel logits {err} from the f32 run, more than "
                             f"{BF16_ERR_RATIO} x the plain version's")
    out["bf16_logit_err_vs_f32"] = err
    stall32 = runs32["graphs"]
    del runs16, runs32
    torch.cuda.empty_cache()
    print("phase 4: request semantics, float32 (widened weights)")
    rq32 = request_paths(cfg32, params32, dev, tok, "f32", {})
    out["requests_f32"] = check_requests(rq32, N, "f32", card, strict=True)
    del rq32
    torch.cuda.empty_cache()
    print("phase 5: serving entry over HTTP, float32 (widened weights)")
    out["serve_f32"] = phase_serve(cfg32, params32, dev, card, "f32", strict=True)
    print("phase 7: speculative decoding, float32 (widened weights)")
    out["spec_f32"] = phase_spec(cfg32, params32, dev, card, "f32", strict=True)
    print("phase 8: serve --model-path, the HF tokenizer and LoRA, float32 (the bf16 "
          "files widened as they load)")
    out["ckpt_f32"] = phase_checkpoint(cfg32, params32, dev, card, "f32", strict=True,
                                       ckpt=f32_root / CKPT_MODEL, adapters=adapters,
                                       tiny=root / "tiny")
    torch.cuda.empty_cache()
    print("phase 10: the rest of serve; embeddings, rerank and classify, float32 "
          "(widened weights)")
    out["api_f32"] = phase_api(cfg32, params32, dev, card, "f32", strict=True,
                               stall_free=stall32, sink=sink)
    params32.clear()
    del cut, stall32
    torch.cuda.empty_cache()
    # phase 6 at full depth: its /debug/slo p50s are held to the client's
    # within SLO_TOLERANCE, and at 8 layers the short TTFT left a few ms of
    # host latency too large a share of it.  ``params`` is widened in place:
    # no phase runs on its bf16 weights after this one
    print(f"phase 6: the request-policy layer over HTTP, float32 (all {cfg.num_layers} "
          "layers, widened weights)")
    _widen(params)
    out["policy_f32"] = phase_policy(dataclasses.replace(cfg, dtype="float32"), params, dev,
                                     card, "f32", strict=True, bare=out["serve_f32"])
    return out


def phase_checkpoint_alone(dev, card: str) -> dict:
    """Phase 8 without phases 3-7 (``--phases checkpoint``): phase 3's
    weights, bf16 then widened to float32."""
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params

    cfg = llama3_8b_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    root = Path(tempfile.mkdtemp(prefix="smg_ckpt_"))
    out = {}
    try:
        written, cfg8, params8 = prepare_checkpoint(cfg, params, root)
        out["bf16"] = phase_checkpoint(cfg8, params8, dev, card, "bf16", strict=False,
                                       ckpt=root / CKPT_MODEL, adapters=written["adapters"],
                                       tiny=root / "tiny")
        del params8
        _widen(params)
        params8 = {**params, "layers": {k: v[:cfg8.num_layers]
                                        for k, v in params["layers"].items()}}
        out["f32"] = phase_checkpoint(dataclasses.replace(cfg8, dtype="float32"), params8,
                                      dev, card, "f32", strict=True, ckpt=root / CKPT_MODEL,
                                      adapters=written["adapters"], tiny=root / "tiny")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_api_alone(dev, card: str) -> dict:
    """Phase 10 without phases 3-9 (``--phases api``): phase 3's weights,
    its graph path under the stall-free policy as the reference, bf16 then
    widened to float32."""
    import dataclasses

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params

    cfg = llama3_8b_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out, sink = {}, {}
    for label in ("bf16", "f32"):
        if label == "f32":
            _widen(params)
            cfg = dataclasses.replace(cfg, dtype="float32")
        stall_free = serve_paths(cfg, params, dev, 32, paths=PATHS[:1],
                                 with_profile=label == "bf16")["graphs"]
        out[f"api_{label}"] = phase_api(cfg, params, dev, card, label, strict=label == "f32",
                                        stall_free=stall_free, sink=sink)
    params.clear()
    torch.cuda.empty_cache()
    return out


def phase_pd_alone(dev, card: str, worker_cli: dict | None = None) -> dict:
    """Phase 13 without phases 3-12 (``--phases pd``): phase 3's weights in
    bf16."""
    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params

    cfg = llama3_8b_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {"pd": phase_pd(cfg, params, dev, card, worker_cli=worker_cli)}
    params.clear()
    torch.cuda.empty_cache()
    return out


def phase_breadth_alone(dev, card: str) -> dict:
    """Phase 12 (d) without the rest of phase 12 (``--phases breadth``):
    Qwen2-VL-7B's weights and tower made from phase 12's seeds, one engine
    on the graph path with phase 12 (b)'s settings, then ``vl_breadth``."""
    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.models.vit import init_vision_params
    from smg_tpu_torch.protocols.sampling import SamplingParams
    from smg_tpu_torch.tokenizer import MockTokenizer

    cfg = ModelConfig.from_hf_config(QWEN2_VL_7B, dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tower = init_vision_params(cfg.vision, torch.Generator(device=dev).manual_seed(0 ^ 0x71510),
                               dev)
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    engine = Engine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=PS, num_pages=2048, auto_size=True,
                                     dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4)),
        params=params, device=dev, tokenizer=tok, vision_params=tower)
    engine.generate(prompt_ids=list(range(1000, 1100)),
                    sampling=SamplingParams(temperature=0.0, max_new_tokens=4))
    try:
        return {"breadth": vl_breadth(engine, tok, "vl bf16", card)}
    finally:
        engine.stop()


def phase_transfer_alone(dev, card: str) -> dict:
    """Phase 13 (c) without phases 3-12 (``--phases transfer``): the
    in-process host PD's texts on the first ``PD_LAYERS`` layers of phase
    3's weights, widened to float32 (``_pd_reference``), then the two gRPC
    worker processes by ``transfer`` and by ``host``."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.tokenizer import MockTokenizer

    t0 = time.perf_counter()
    cfg = llama3_8b_config()
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    jobs = _pd_jobs(13)
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    p4 = {**{k: v.float() for k, v in full.items() if k != "layers"},
          "layers": {k: v[:PD_LAYERS].float() for k, v in full["layers"].items()}}
    del full
    ref = _pd_reference(dataclasses.replace(cfg, num_layers=PD_LAYERS, dtype="float32"), p4,
                        dev, tok, jobs)
    del p4
    gc.collect()
    torch.cuda.empty_cache()
    failures: list = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [pd] CHECK FAILED: {what}")

    out = {"grpc": pd_grpc(cfg, dev, tok, jobs, ref, expect)}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 13 (c) took {out['seconds']:.1f} s ({card})")
    if failures:
        raise AssertionError(f"phase 13 (c): {len(failures)} checks failed: {failures}")
    return out


def phase_mesh_alone(dev, card: str) -> dict:
    """Phase 14 (d) without the rest of phase 14 (``--phases mesh``): two of
    this script's worker processes (``pd_worker_main``, as phase 14 (c)
    runs them) behind the three mesh gateways."""
    import dataclasses

    from smg_tpu_torch.models.config import PRESETS

    t0 = time.perf_counter()
    cfg = PRESETS[SERVE_MODEL]()
    ports = {"a": _free_port(), "b": _free_port()}
    spec = dict(config=dataclasses.asdict(cfg), layers=PD_LAYERS, pages=PD_GRPC_PAGES,
                device=str(dev))
    children = {k: Child(f"worker-{k}", [sys.executable, REPO / "chip_smoke.py", "--pd-worker",
                                         json.dumps({**spec, "port": p})])
                for k, p in ports.items()}
    failures: list = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [launch] CHECK FAILED: {what}")

    try:
        for k, p in ports.items():
            _grpc_up(p, children[k], f"worker {k}")
        urls = {k: f"127.0.0.1:{p}" for k, p in ports.items()}
        out = {"mesh": launch_routing(urls, ports, expect, parts=("mesh",))}
    finally:
        codes = {k: c.stop() for k, c in children.items()}
    expect(codes == {"a": 0, "b": 0}, f"worker exit codes {codes}")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 14 (d) took {out['seconds']:.1f} s ({card})")
    if failures:
        raise AssertionError(f"phase 14 (d): {len(failures)} checks failed: {failures}")
    return out


# ---- phase 18: the training step ----

TRAIN_T = 512  # tokens of the full-width step's one sequence (B=1)
TRAIN_STEPS = 8  # steps of (a), all on one batch
TRAIN_SEED = 18  # the batches' and prompts' numpy seed
TRAIN_MARGIN = 3 << 30  # (a)'s headroom above the reckoning: allocator blocks, cuBLAS
TRAIN_NEW = 16  # greedy tokens of (b)'s stream
TRAIN_PAGES = 256  # KV pages of (b)'s float32 engine: 4096 tokens
TRAIN_LOGPROB_ATOL = 1e-4  # (b): the engine's logprobs against forward_train's
TRAIN_TINY_STEPS = 3  # (c)
TRAIN_WAIT_S = 300  # the phase's process, start to exit
# (a)'s device time by kernel class, by substrings of the kernels' names:
# fused AdamW's multi-tensor kernel, cuBLAS products, reductions (the norms,
# softmax, the loss), the rest elementwise
TRAIN_KERNEL_CLASSES = {"adamw": ("multi_tensor_apply", "fused_adam"),
                        "gemm": ("gemm", "nvjet", "xmma", "cutlass", "splitK"),
                        "reduce": ("reduce_kernel", "softmax", "norm")}


def train_step_work(cfg, params: dict, B: int, T: int) -> dict:
    """What one AdamW step of ``params`` on [B, T] tokens must do, and the
    memory it needs.  Operations: 6 per matmul weight and token (forward 2,
    backward 4; the embedding table is a lookup, not a product) plus dense
    float32 attention over every query and key pair, as the reference
    computes it (4 x B x H x D x T^2 a layer forward, twice that backward).
    Bytes: fused AdamW reads weight, gradient and both moments and writes
    weight and moments (7 x the weights' bytes), the gradient norm reads the
    gradients once more.  Memory (``train_need``): the activations autograd
    keeps, per layer its float32 attention scores and probabilities, its
    four MLP products and about a dozen float32 [B, T, E] tensors (norms,
    rope, residuals), plus the float32 logits, their log-softmax and
    gradient."""
    L, E, H, D = cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim
    F_, V = cfg.intermediate_size, cfg.vocab_size
    item = next(iter(params["layers"].values())).element_size()
    n_all = sum(t.numel() for t in _tensors(params))
    n_matmul = n_all - params["embed"].numel() - params["final_norm"].numel() - sum(
        params["layers"][k].numel() for k in params["layers"] if k.endswith("norm"))
    if cfg.tie_word_embeddings:  # the table is also the unembedding product
        n_matmul += params["embed"].numel()
    flops = 6 * n_matmul * B * T + L * 12 * B * H * D * T * T
    nbytes = (7 + 1) * n_all * item
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    layer_bytes = sum(t[0].numel() for t in params["layers"].values()) * item
    return dict(params=n_all, matmul_params=n_matmul, flops=flops, bytes=nbytes,
                bound_ms=t_ops + t_bytes, bound_parts_ms={"operations": t_ops,
                                                          "bytes": t_bytes},
                weight_bytes=n_all * item, layer_bytes=layer_bytes,
                act_layer_bytes=2 * B * H * T * T * 4 + 4 * B * T * F_ * item
                + 12 * B * T * E * 4,
                logits_bytes=3 * B * T * V * 4)


def train_need(work: dict, layers: int, full: int) -> int:
    """Peak bytes of a step at ``layers`` of ``full`` layers: weights and
    both moments, plus the larger of the gradients (all present once
    backward ends, when the activations are gone) and the activations with
    the logits (all present once forward ends, before any gradient): during
    backward one shrinks as the other grows."""
    w = work["weight_bytes"] - (full - layers) * work["layer_bytes"]
    act = layers * work["act_layer_bytes"] + work["logits_bytes"]
    return 3 * w + max(w, act)


def train_depth(work: dict, full: int, room: int) -> int:
    """The deepest stack (every layer, when it fits) whose ``train_need``
    leaves ``TRAIN_MARGIN`` of ``room`` bytes."""
    return max((n for n in range(1, full + 1)
                if train_need(work, n, full) + TRAIN_MARGIN <= room), default=1)


def train_vs_serving(cfg, params: dict, dev, card: str) -> dict:
    """Phase 18 (b): the first ``F32_LAYERS`` layers of ``params`` widened
    to float32 with float32 KV.  A prompt sharing a 600-token prefix with an
    earlier request is served greedily with phase 3's engine settings
    (decode graphs, overlap, horizon 4; stepped inline): a radix hit, then
    its last 748 tokens in two prefill chunks; ``forward_train`` over the
    prompt and the stream is held to it: its last prompt position's logits
    to the prefill's, its argmax to every token, its log-softmax to every
    reported logprob."""
    import dataclasses

    import numpy as np
    import torch

    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.models.llama import LlamaModel
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams

    N = F32_LAYERS
    cfg32 = dataclasses.replace(cfg, num_layers=N, dtype="float32")
    p32 = {**{k: v.float() for k, v in params.items() if k != "layers"},
           "layers": {k: v[:N].float() for k, v in params["layers"].items()}}
    rng = np.random.default_rng(TRAIN_SEED)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    shared = ids(600)
    first, prompt = shared + ids(40), shared + ids(740)
    engine = Engine(EngineConfig(
        model=cfg32,
        cache=CacheConfig(page_size=PS, num_pages=TRAIN_PAGES, auto_size=False,
                          dtype="float32"),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096, max_prefill_tokens=512,
                                  decode_horizon=4, overlap_schedule=True),
        decode_graphs=True), params=p32, device=dev)
    sp = SamplingParams(temperature=0.0, max_new_tokens=TRAIN_NEW, ignore_eos=True)
    engine.generate(first, sp)  # the shared prefix goes into the radix cache
    runner = engine.runner
    recorded: list = []
    orig = runner.model.forward_prefill_batched

    def recording(*a, **kw):
        out = orig(*a, **kw)
        if out is not None:
            recorded.append(out.float())
        return out

    runner.model.forward_prefill_batched = recording
    for k in runner.stats:
        runner.stats[k] = 0
    torch.cuda.synchronize()
    dk.launches = pk.launches = 0
    res = engine.generate(prompt, sp)
    torch.cuda.synchronize()
    launches = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
    runner.model.forward_prefill_batched = orig
    stats = dict(runner.stats)
    audit = engine.loads()["audit"]
    engine.stop()
    del engine, runner
    check_launches({"stats": stats, "launches": launches}, N, "train (b)", plain=False)
    with torch.no_grad():
        dense = LlamaModel(cfg32, p32).forward_train(torch.tensor(
            [prompt + res.token_ids[:-1]], device=dev))[0, len(prompt) - 1:]
    del p32
    logp = torch.log_softmax(dense, dim=-1)
    greedy = dense.argmax(-1).tolist()
    ref_lp = logp.gather(-1, torch.tensor(res.token_ids, device=dev)[:, None])[:, 0]
    out = dict(
        prompt_tokens=res.prompt_tokens, cached_tokens=res.cached_tokens,
        prefill_calls=stats["prefill_calls"], decode_columns=stats["decode_columns"],
        launches=launches, audit_clean=audit["clean"] and not audit["leaked_pages"],
        prefill_logit_gap=float((dense[0] - recorded[-1]).abs().max()) if recorded else None,
        tokens_equal=greedy == res.token_ids,
        logprob_gap=float((ref_lp.cpu() - torch.tensor(res.logprobs)).abs().max()),
        max_abs_logit=float(dense[0].abs().max()))
    print(f"  [train (b), {N} layers f32] prompt {out['prompt_tokens']} (cached "
          f"{out['cached_tokens']}, {out['prefill_calls']} prefill calls), {TRAIN_NEW} greedy "
          f"tokens: prefill logits against forward_train max_abs_err "
          f"{out['prefill_logit_gap']:.3e} (max |logit| {out['max_abs_logit']:.3f}; atol "
          f"{F32_LOGIT_ATOL}), logprobs max_abs_err {out['logprob_gap']:.3e} (atol "
          f"{TRAIN_LOGPROB_ATOL}), tokens equal: {out['tokens_equal']}; launches {launches}")
    problems = []
    if out["cached_tokens"] <= 0 or out["prefill_calls"] != 2:
        problems.append("the prompt was not two chunks over a radix prefix")
    if len(recorded) != 1 or not out["prefill_logit_gap"] <= F32_LOGIT_ATOL:
        problems.append("prefill logits")
    if not out["tokens_equal"] or len(res.token_ids) != TRAIN_NEW:
        problems.append(f"greedy tokens {res.token_ids} != forward_train's {greedy}")
    if not out["logprob_gap"] <= TRAIN_LOGPROB_ATOL:
        problems.append("logprobs")
    if not out["audit_clean"]:
        problems.append(f"audit {audit}")
    if problems:
        raise AssertionError(f"phase 18 (b): {problems}")
    return out


def train_full(cfg, params: dict, dev, card: str) -> dict:
    """Phase 18 (a): ``TRAIN_STEPS`` AdamW steps of ``params`` (trained in
    place) through ``make_train_step`` on one batch of ``TRAIN_T`` tokens,
    at full depth unless the card's free memory says otherwise (then the
    deepest that fits, the cut printed).  Each step is timed from the host
    with the card drained before and after, and split by CUDA events at the
    optimizer's call."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from smg_tpu_torch.train.step import make_train_step

    gc.collect()  # (b)'s engine holds its float32 weights in a reference cycle
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    work = train_step_work(cfg, params, 1, TRAIN_T)
    full_depth = cfg.num_layers
    room = free + work["weight_bytes"]  # the weights are already in
    layers = train_depth(work, full_depth, room)
    print(f"  [train (a)] reckoning: {work['params']} parameters, {work['weight_bytes']} "
          f"bytes of {cfg.dtype} weights; 3 x that (weights, both moments) plus the larger "
          f"of the gradients and the activations (~{work['act_layer_bytes']} a layer, "
          f"logits {work['logits_bytes']}): {train_need(work, full_depth, full_depth)} bytes "
          f"at full depth; the card has {free} free of {total} beside the weights, "
          f"{TRAIN_MARGIN} kept spare: depth {layers} of {full_depth}")
    if layers < full_depth:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        cut = {k: v[:layers].clone() for k, v in params["layers"].items()}
        params["layers"] = cut
        torch.cuda.empty_cache()
        work = train_step_work(cfg, params, 1, TRAIN_T)
    rng = np.random.default_rng(TRAIN_SEED)
    seq = rng.integers(1000, 120000, (1, TRAIN_T + 1))
    tokens, targets = seq[:, :-1], seq[:, 1:]
    mask = np.ones((1, TRAIN_T), np.int32)
    init, step = make_train_step(cfg, device=dev)
    state = init(params=params)
    events = []
    orig = torch.optim.AdamW.step

    def timed(self, *a, **kw):  # events at the optimizer's call
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig(self, *a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    torch.optim.AdamW.step = timed
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    try:
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            with prof if i == TRAIN_STEPS - 1 else contextlib.nullcontext():
                state, m = step(state, tokens, targets, mask)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            opt_a, opt_b = events[-1]
            rows.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             wall_ms=wall, fwd_bwd_ms=start.elapsed_time(opt_a),
                             adamw_ms=opt_a.elapsed_time(opt_b)))
    finally:
        torch.optim.AdamW.step = orig
    peak = torch.cuda.max_memory_allocated(dev)
    # the first step loads the backward's kernels and grows the allocator;
    # the last runs under the profiler
    timed_rows = rows[1:-1]
    ms = statistics.median(r["wall_ms"] for r in timed_rows)
    busy, by_name, _n = device_time(prof)
    by_class = {}
    for name, t in by_name.items():
        cls = next((c for c, keys in TRAIN_KERNEL_CLASSES.items()
                    if any(k in name for k in keys)), "rest")
        by_class[cls] = by_class.get(cls, 0.0) + t
    out = dict(layers=cfg.num_layers, depth_cut=cfg.num_layers < full_depth, B=1, T=TRAIN_T,
               steps=rows, state_step=state.step, ms_per_step=ms,
               tokens_per_s=TRAIN_T / ms * 1e3,
               fwd_bwd_ms=statistics.median(r["fwd_bwd_ms"] for r in timed_rows),
               adamw_ms=statistics.median(r["adamw_ms"] for r in timed_rows),
               device_busy_ms=busy, busy_share=busy / ms, device_ms_by_class=by_class,
               peak_bytes=peak, free_before=free, work=work,
               share_of_bound=work["bound_ms"] / ms)
    for i, r in enumerate(rows):
        print(f"  [train (a)] step {i + 1}: loss {r['loss']:.4f}, grad_norm "
              f"{r['grad_norm']:.4f}, {r['wall_ms']:.2f} ms (forward+backward+norm "
              f"{r['fwd_bwd_ms']:.2f}, AdamW {r['adamw_ms']:.2f})")
    print(f"  [{card}] train (a) Llama-3-8B {cfg.num_layers} layers {cfg.dtype}, B=1 "
          f"T={TRAIN_T}: "
          f"{ms:.2f} ms a step (median of {len(timed_rows)}), {out['tokens_per_s']:.1f} "
          f"tokens/s, peak {peak} bytes allocated; bound {work['bound_ms']:.2f} ms "
          f"({work['flops']:.4e} operations at bf16 peak {work['bound_parts_ms']['operations']:.2f}"
          f" + {work['bytes']} bytes {work['bound_parts_ms']['bytes']:.2f}): "
          f"{out['share_of_bound']:.3f} of it; the profiled step's device busy "
          f"{busy:.2f} ms ({out['busy_share']:.3f} of a step): " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))
    problems = []
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        problems.append("a non-finite loss or grad_norm")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        problems.append(f"loss did not fall: {rows[0]['loss']} -> {rows[-1]['loss']}")
    if state.step != TRAIN_STEPS:
        problems.append(f"state.step {state.step} after {TRAIN_STEPS} steps")
    if problems:
        raise AssertionError(f"phase 18 (a): {problems}")
    return out


def train_tiny(dev) -> dict:
    """Phase 18 (c): ``TRAIN_TINY_STEPS`` float32 steps of the tiny config
    on the card and on the CPU from the same weights and batches.  The loss
    and ``grad_norm`` of every step agree to 1e-5 relative, and after the
    last step every parameter to one learning rate (a step's move) with
    99.9% of each tensor's elements within 1e-3 of it plus 8 float32 ulps
    (``tests/test_torch_train.py`` says why Adam needs the first)."""
    import numpy as np
    import torch

    from smg_tpu_torch.models.config import tiny_test_config
    from smg_tpu_torch.train.step import make_train_step

    cfg = tiny_test_config()
    lr = 1e-4
    init_c, step_c = make_train_step(cfg, device="cpu", learning_rate=lr)
    init_d, step_d = make_train_step(cfg, device=dev, learning_rate=lr)
    cpu = init_c(seed=0)
    card = init_d(params=_map_tree(cpu.params, torch.clone))
    rng = np.random.default_rng(TRAIN_SEED)
    metrics = []
    for _ in range(TRAIN_TINY_STEPS):
        seq = rng.integers(0, cfg.vocab_size, (2, 33))
        batch = (seq[:, :-1], seq[:, 1:], (rng.random((2, 32)) > 0.25).astype(np.int32))
        cpu, mc = step_c(cpu, *batch)
        card, md = step_d(card, *batch)
        metrics.append({k: (float(mc[k]), float(md[k])) for k in ("loss", "grad_norm")})
    worst, fine = 0.0, 1.0
    ulps = 8 * float(np.finfo(np.float32).eps)
    for a, b in zip(_tensors(cpu.params), _tensors(card.params), strict=True):
        d = (a - b.cpu()).abs()
        worst = max(worst, float(d.max()))
        fine = min(fine, float((d <= 1e-3 * lr + ulps * a.abs()).float().mean()))
    rel = max(abs(c - d) / abs(c) for m in metrics for c, d in m.values())
    out = dict(metrics=metrics, metric_rel_err=rel, param_max_abs_err=worst,
               param_fine_share=fine, lr=lr)
    print(f"  [train (c)] tiny float32, {TRAIN_TINY_STEPS} steps card against CPU: loss and "
          f"grad_norm max rel err {rel:.3e} (rtol 1e-5), params max_abs_err {worst:.3e} "
          f"(atol {lr}), {fine:.5f} of each tensor within 1e-3 x lr (at least 0.999)")
    if not (rel <= 1e-5 and worst <= lr and fine >= 0.999):
        raise AssertionError(f"phase 18 (c): the card's step differs from the CPU's: {out}")
    return out


def train_worker_main(spec: dict) -> int:
    """Phase 18 in a process of its own (``--train-worker``), so it starts on
    an empty card: phase 3's weights made from the seed, (b), then (a) on
    the same weights, then (c); then phase 22; the readings written to
    ``spec["report"]`` as JSON."""
    import torch

    from smg_tpu_torch.models.config import llama3_8b_config
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.ops.cuda import build
    from smg_tpu_torch.parallel import leader
    from smg_tpu_torch.train import step  # noqa: F401 - imported before the wait
    from smg_tpu_torch.train.leader import TRAIN_PRELOAD

    leader.prestart(TRAIN_PRELOAD)  # phase 22's rank processes fork from it
    # torch.optim imports torch._dynamo when it builds the first optimizer
    # (seconds): here, before the wait, rather than inside (a)'s first step
    import torch._dynamo  # noqa: F401
    if not await_go(spec):  # the card is not ours yet
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load()
    t0 = time.perf_counter()
    cfg = llama3_8b_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {"init_s": time.perf_counter() - t0}
    out["serving"] = train_vs_serving(cfg, params, dev, spec["card"])
    out["step"] = train_full(cfg, params, dev, spec["card"])
    params.clear()
    out["tiny"] = train_tiny(dev)
    out["mesh"] = phase_train_mesh(dev, spec["card"], out["step"])
    Path(spec["report"]).write_text(json.dumps(out))
    return 0


def phase_train(dev, card: str, early: EarlyChild) -> dict:
    """Phases 18 and 22: ``train_worker_main`` in ``early``, let go once
    this process has given the card back; its report read."""
    import gc

    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"  free before phase 18: {free} of {total} bytes "
          f"({torch.cuda.memory_allocated(dev)} still allocated here)")
    code, out = early.run(TRAIN_WAIT_S)
    if code != 0 or not out:
        raise AssertionError(f"phase 18's process exited {code}")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phases 18 and 22 took {out['seconds']:.1f} s ({card})")
    return out


# ---- phase 22: the sharded training step ----

MESH_TRAIN_LAYERS = 2  # (a)'s float32 depth at full width
MESH_TRAIN_B, MESH_TRAIN_T = 4, 512  # (a)'s batch, and (b)'s pp batch
MESH_TRAIN_STEPS = 2  # (a): steps of each mesh, each held to the one device's
MESH_TRAIN_RTOL = 1e-5  # (a): loss and grad_norm against the one-device step
MESH_TRAIN_NORM_RTOL = 1e-4  # (a): each leaf's mu and nu norm against it
MESH_TRAIN_SEED = 22  # the batches' numpy seed
#: (a)'s meshes of Llama-3-8B, every rank on the one card over gloo
MESH_TRAIN_MESHES = {"dp2": dict(dp=2), "tp2": dict(tp=2), "sp2": dict(sp=2),
                     "pp2": dict(pp=2), "dp2_tp2": dict(dp=2, tp=2)}
#: (b)'s full-depth bf16 meshes: (axis sizes, B)
MESH_TRAIN_FULL = {"tp2": (dict(tp=2), 1), "pp2": (dict(pp=2), MESH_TRAIN_B)}


def mesh_train_batches(vocab: int, B: int, n: int) -> list:
    """``n`` batches of [B, ``MESH_TRAIN_T``] tokens, pre-shifted targets
    and a loss mask with holes (the loss divides by the whole batch's
    count on every rank)."""
    import numpy as np

    rng = np.random.default_rng(MESH_TRAIN_SEED)
    out = []
    for _ in range(n):
        seq = rng.integers(0, vocab, (B, MESH_TRAIN_T + 1))
        out.append((seq[:, :-1], seq[:, 1:],
                    (rng.random((B, MESH_TRAIN_T)) > 0.25).astype(np.int32)))
    return out


def mesh_train_run(cfg, sizes: dict, dev, batches: list, pool) -> dict:
    """``make_train_step`` of ``cfg`` on ``sizes`` (every rank on ``dev``,
    the followers lent by ``pool``; {} is one device) from seed 0: each
    step's loss and ``grad_norm``, then every leaf's norm (assembled from
    the ranks' sums of squares), each rank's peak bytes and the seconds at
    each stage."""
    import gc

    import torch

    from smg_tpu_torch.train import leaf_norms, make_train_step

    t0 = time.perf_counter()
    n = math.prod(sizes.values()) if sizes else 1
    init, step = make_train_step(cfg, device=dev, mesh=sizes or None,
                                 devices=[dev] * n if n > 1 else None, ranks=pool)
    marks = {"start": time.perf_counter() - t0}
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        state = init(seed=0)
        if n > 1:
            step.trainer.rank_memory()  # the ranks' peaks count from here
        marks["init"] = time.perf_counter() - t0
        rows = []
        for i, batch in enumerate(batches):
            state, m = step(state, *batch)
            rows.append({k: float(v) for k, v in m.items()})
            marks[f"step{i + 1}"] = time.perf_counter() - t0
        peaks = ([r["peak"] for r in step.trainer.rank_memory()] if n > 1
                 else [torch.cuda.max_memory_allocated(dev)])
        norms = leaf_norms(state)
        marks["norms"] = time.perf_counter() - t0
    finally:
        step.close()
    del state, init, step
    gc.collect()
    torch.cuda.empty_cache()
    marks["closed"] = time.perf_counter() - t0
    return dict(metrics=rows, norms=norms, seconds=marks["closed"], marks=marks,
                peak_bytes=peaks)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def mesh_train_parity(cfg, meshes: dict, dev, label: str, pool) -> dict:
    """Phase 22 (a) for one model: the one-device step, then each mesh of
    ``meshes`` in turn, ``MESH_TRAIN_STEPS`` float32 steps each on the same
    batches; every mesh's loss and ``grad_norm`` within
    ``MESH_TRAIN_RTOL`` of the one device's at every step, every leaf's
    ``mu`` and ``nu`` norm within ``MESH_TRAIN_NORM_RTOL``."""
    batches = mesh_train_batches(cfg.vocab_size, MESH_TRAIN_B, MESH_TRAIN_STEPS)
    one = mesh_train_run(cfg, {}, dev, batches, pool)
    print(f"  [train mesh (a) {label}] one device: " + "; ".join(
        f"loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}" for r in one["metrics"])
        + f" ({one['seconds']:.1f} s)")
    out, problems = {"one": one}, []
    for name, sizes in meshes.items():
        r = mesh_train_run(cfg, sizes, dev, batches, pool)
        metric_err = max(_rel(g[k], w[k]) for g, w in zip(r["metrics"], one["metrics"])
                         for k in ("loss", "grad_norm"))
        moments = [k for k in one["norms"] if k.startswith(("mu.", "nu."))]
        norm_err = {k: _rel(r["norms"][k], one["norms"][k]) for k in moments}
        worst = max(norm_err, key=norm_err.get)
        r.update(metric_rel_err=metric_err, moment_norm_rel_err=norm_err[worst],
                 worst_leaf=worst, param_norm_rel_err=max(
                     _rel(r["norms"][k], one["norms"][k]) for k in one["norms"]
                     if k.startswith("params.")))
        out[name] = r
        print(f"  [train mesh (a) {label}] {name} {sizes}: loss and grad_norm max rel err "
              f"{metric_err:.3e} (rtol {MESH_TRAIN_RTOL}), mu/nu leaf norms max rel err "
              f"{norm_err[worst]:.3e} at {worst} (rtol {MESH_TRAIN_NORM_RTOL}; "
              f"{len(moments)} leaves), params {r['param_norm_rel_err']:.3e}; peak bytes a "
              f"rank {r['peak_bytes']}; s at " + ", ".join(
                  f"{k} {v:.2f}" for k, v in r["marks"].items()))
        if not metric_err <= MESH_TRAIN_RTOL:
            problems.append(f"{name}: loss or grad_norm {r['metrics']} against {one['metrics']}")
        if not norm_err[worst] <= MESH_TRAIN_NORM_RTOL:
            problems.append(f"{name}: {worst} norm rel err {norm_err[worst]}")
        if set(r["norms"]) != set(one["norms"]):
            problems.append(f"{name}: leaves {sorted(set(r['norms']) ^ set(one['norms']))}")
    if problems:
        raise AssertionError(f"phase 22 (a) {label}: {problems}")
    return out


def mesh_train_full(cfg, dev, card: str, phase18: dict | None, pool) -> dict:
    """Phase 22 (b): Llama-3-8B at full depth in bf16 through each mesh of
    ``MESH_TRAIN_FULL``: a warm-up step, then a step timed from the host
    (every rank's device drained when a step returns); the two losses, the
    peak device bytes of each rank over both steps, beside phase 18 (a)'s
    one-device step."""
    import gc

    import torch

    from smg_tpu_torch.train import make_train_step

    out = {}
    for name, (sizes, B) in MESH_TRAIN_FULL.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        init, step = make_train_step(cfg, device=dev, mesh=sizes, devices=[dev, dev],
                                     ranks=pool)
        marks = {"start": time.perf_counter() - t0}
        try:
            state = init(seed=0)
            step.trainer.rank_memory()  # the peaks count from here
            marks["init"] = time.perf_counter() - t0
            losses, walls = [], []
            for batch in mesh_train_batches(cfg.vocab_size, B, 2):
                t = time.perf_counter()
                state, m = step(state, *batch)
                walls.append((time.perf_counter() - t) * 1e3)
                losses.append(float(m["loss"]))
            memory = step.trainer.rank_memory()
            marks["steps"] = time.perf_counter() - t0
        finally:
            step.close()
        del state, init, step
        marks["closed"] = time.perf_counter() - t0
        r = dict(sizes=sizes, B=B, T=MESH_TRAIN_T, losses=losses, warmup_ms=walls[0],
                 ms=walls[1], peak_bytes=[m["peak"] for m in memory], marks=marks,
                 seconds=marks["closed"])
        out[name] = r
        beside = (f"; phase 18 (a)'s one device at B=1: {phase18['ms_per_step']:.2f} ms"
                  if phase18 else "")
        print(f"  [{card}] train mesh (b) {name} {sizes}, 32 layers bf16, B={B} T={MESH_TRAIN_T}: "
              f"losses {losses[0]:.4f}, {losses[1]:.4f}; {r['ms']:.2f} ms a step after a "
              f"{r['warmup_ms']:.2f} ms warm-up{beside}; peak bytes a rank {r['peak_bytes']}; "
              f"s at " + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"phase 22 (b) {name}: {r}")
    return out


def phase_train_mesh(dev, card: str, phase18: dict | None = None) -> dict:
    """Phase 22: (a) float32 parity of the meshes at Llama-3-8B's full
    width and ``MESH_TRAIN_LAYERS`` layers, and of ep=2 against ep=1 at
    Qwen3-30B-A3B's at one layer; (b) tp=2 and pp=2 at full depth in bf16;
    every mesh's followers lent by one ``RankPool`` of 3 processes (forked,
    their CUDA set up and their kernels loaded once for all meshes); (c) no
    rank process left once the pool is closed."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.models.config import ModelConfig, llama3_8b_config
    from smg_tpu_torch.train import RankPool

    t0 = time.perf_counter()
    gc.collect()  # phase 18's tensors
    torch.cuda.empty_cache()
    llama = llama3_8b_config()
    pool = RankPool(3)
    try:
        out = {"parity": mesh_train_parity(
            dataclasses.replace(llama, num_layers=MESH_TRAIN_LAYERS, dtype="float32"),
            MESH_TRAIN_MESHES, dev, f"Llama-3-8B {MESH_TRAIN_LAYERS} layers f32", pool)}
        moe = dataclasses.replace(ModelConfig.from_hf_config(QWEN3_30B_A3B), num_layers=1,
                                  dtype="float32")
        out["moe_parity"] = mesh_train_parity(moe, {"ep2": dict(ep=2)}, dev,
                                              "Qwen3-30B-A3B 1 layer f32", pool)
        pool.retire(1)  # (b)'s meshes have two ranks: the card for their bytes
        out["full"] = mesh_train_full(llama, dev, card, phase18, pool)
    finally:
        pool.close()
    out["rank_pids"] = pool.pids()
    out["ranks_left"] = [p for p in out["rank_pids"] if not _gone(p)]
    if out["ranks_left"]:
        raise AssertionError(f"phase 22 (c): rank processes left {out['ranks_left']}")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 22 took {out['seconds']:.1f} s ({card}); its {len(out['rank_pids'])} rank "
          f"processes gone: {not out['ranks_left']}")
    return out


# phase 19: data-parallel replicas in one gRPC worker
DP_PAGES = 2048  # KV pages of each replica (num_pages; auto-sizing would give
#                  the first replica nearly all of the card: runner.py sizes after
#                  its own weights)
DP_NEW = 32  # new tokens of the pinned greedy streams
DP_LONG_NEW = 1024  # a stream still running while the next requests come
DP_GATEWAY_STREAMS = 4  # concurrent streams through each launch gateway
DP_COLUMN_LANES = 4  # lanes of each replica's timed decode
DP_COLUMN_NEW = 128  # new tokens of each timed lane
DP_WAIT_S = 300  # the phase's process, start to exit


def _admitted(engines) -> list:
    """Each replica's prompt tokens admitted so far, cached and computed."""
    out = []
    for e in engines:
        loads = e.loads(include_audit=False)
        out.append(loads["cached_prompt_tokens"] + loads["computed_prompt_tokens"])
    return out


def _quiescent(engines, what: str) -> list:
    """Wait until no replica has work; their audits."""
    wait_for(lambda: not any(e.has_work() for e in engines), what, timeout=DP_WAIT_S)
    return [e.audit() for e in engines]


def dp_columns(lanes: dict, new: int) -> dict:
    """Decode ms a column of each engine in ``lanes`` (engine -> prompts),
    all submitted at once: from the moment every lane of an engine has its
    first token to the moment its last lane finishes, over the decode
    columns its runner ran in between (read on its loop thread)."""
    import threading

    from smg_tpu_torch.protocols.sampling import SamplingParams

    marks = {}
    done = threading.Event()
    lock = threading.Lock()
    sp = SamplingParams(temperature=0.0, max_new_tokens=new, ignore_eos=True)
    for n, (engine, prompts) in enumerate(lanes.items()):
        m = marks[engine] = dict(started=set(), finished=0, lanes=len(prompts))

        def on_output(out, engine=engine, m=m):
            with lock:
                if out.output_tokens and not out.finished and out.rid not in m["started"]:
                    m["started"].add(out.rid)
                    if len(m["started"]) == m["lanes"]:
                        m["t0"] = time.perf_counter()
                        m["c0"] = engine.runner.stats["decode_columns"]
                if out.finished:
                    m["finished"] += 1
                    if m["finished"] == m["lanes"]:
                        m["t1"] = time.perf_counter()
                        m["c1"] = engine.runner.stats["decode_columns"]
                        if all(x["finished"] == x["lanes"] for x in marks.values()):
                            done.set()

        for i, ids in enumerate(prompts):
            engine.submit(ids, sp, rid=f"col-{n}-{i}-{time.monotonic_ns()}",
                          on_output=on_output)
    if not done.wait(DP_WAIT_S):
        raise AssertionError(f"timed decode lanes did not finish: {list(marks.values())}")
    out = []
    for m in marks.values():
        if "t0" not in m or m["c1"] <= m["c0"]:
            raise AssertionError(f"a timed decode window is empty: {m}")
        m.pop("started")
        out.append(dict(ms_per_column=(m["t1"] - m["t0"]) * 1e3 / (m["c1"] - m["c0"]),
                        columns=m["c1"] - m["c0"]))
    return out


def dp_worker_main(spec: dict) -> int:
    """Phase 19 in a process of its own (``--dp-worker``): phase 13 (c)'s
    worker weights (phase 3's seed, the first ``PD_LAYERS`` layers widened
    to float32) shared by two replica engines served by one
    ``serve_worker_async(engines=[e0, e1])`` and a third engine served
    alone; the checks through ``GrpcWorkerClient`` and through two
    ``launch`` gateways (``--dp-aware``, ``--no-dp-aware``) run in this
    process; each replica's decode column alone and beside the other's;
    the kernels' launches of the phase.  Readings to ``spec["report"]``."""
    import asyncio
    import dataclasses
    import threading

    import numpy as np
    import torch

    from smg_tpu_torch import cli
    from smg_tpu_torch.gateway.launch import _run_gateway
    from smg_tpu_torch.gateway.worker_client import WorkerGenerateRequest
    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.models.llama import init_params
    from smg_tpu_torch.ops.cuda import build
    from smg_tpu_torch.ops.cuda import decode_attention as dk
    from smg_tpu_torch.ops.cuda import prefill_attention as pk
    from smg_tpu_torch.protocols.sampling import SamplingParams
    from smg_tpu_torch.rpc import server as rpc_server
    from smg_tpu_torch.rpc.client import GrpcWorkerClient
    from smg_tpu_torch.tokenizer import MockTokenizer

    t_start = time.perf_counter()
    card = spec["card"]
    dev = torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        build.load()
    cfg = ModelConfig(**spec["config"])
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = {**{k: v.float() for k, v in full.items() if k != "layers"},
              "layers": {k: v[:PD_LAYERS].float() for k, v in full["layers"].items()}}
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, num_layers=PD_LAYERS, dtype="float32")
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    engines = [_pd_engine(cfg4, params, dev, tok, DP_PAGES) for _ in range(2)]
    solo = _pd_engine(cfg4, params, dev, tok, DP_PAGES)
    every = [*engines, solo]
    for e in every:  # cuBLAS handles, the allocator, a first graph; not counted
        e.generate(prompt_ids=list(range(1000, 1100)),
                   sampling=SamplingParams(temperature=0.0, max_new_tokens=4))
    out = dict(card=card, pages=[e.runner.spec.num_pages for e in every],
               setup_s=time.perf_counter() - t_start)
    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [dp] CHECK FAILED: {what}")

    ranks: list = []
    engine_for = rpc_server.SchedulerServicer._engine_for

    def recording(self, rank):
        ranks.append(rank)
        return engine_for(self, rank)

    rpc_server.SchedulerServicer._engine_for = recording
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="dp-grpc", daemon=True)
    thread.start()

    def run(coro, timeout=DP_WAIT_S):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    rng = np.random.default_rng(19)
    ids = lambda n: rng.integers(1000, 120000, n).tolist()  # noqa: E731
    servers, clients, gateways = {}, {}, {}
    try:
        for e in every:
            e.start()
        servers["dp"] = run(rpc_server.serve_worker_async(None, 0, "127.0.0.1",
                                                          engines=engines))
        servers["solo"] = run(rpc_server.serve_worker_async(solo, 0, "127.0.0.1"))
        urls = {k: f"127.0.0.1:{s._bound_port}" for k, s in servers.items()}

        async def dial():
            return {k: GrpcWorkerClient(u) for k, u in urls.items()}

        clients.update(run(dial()))
        client = clients["dp"]
        for e in every:
            for k in e.runner.stats:
                e.runner.stats[k] = 0
        dk.launches = 0
        pk.launches = 0

        def req(rank, prompt, new, rid):
            return WorkerGenerateRequest(
                rid=rid, input_ids=prompt, data_parallel_rank=rank,
                sampling=SamplingParams(temperature=0.0, max_new_tokens=new, ignore_eos=True))

        async def tokens(c, rank, prompt, new, rid):
            return [t async for ch in c.generate(req(rank, prompt, new, rid))
                    for t in ch.token_ids]

        info = run(client.get_model_info())
        out["dp_size"] = info["dp_size"]
        expect(info["dp_size"] == 2, f"ModelInfo.dp_size {info['dp_size']}")
        # pinned ranks against the one-engine worker
        prompt = ids(300)
        streams, moved = {}, {}
        for rank in (0, 1):
            before = _admitted(engines)
            streams[rank] = run(tokens(client, rank, prompt, DP_NEW, f"pin-{rank}"))
            moved[rank] = [a - b for a, b in zip(_admitted(engines), before)]
        streams["solo"] = run(tokens(clients["solo"], -1, prompt, DP_NEW, "solo"))
        out["streams_equal"] = streams[0] == streams[1] == streams["solo"]
        expect(out["streams_equal"] and len(streams[0]) == DP_NEW,
               f"greedy streams rank 0 {streams[0]}, rank 1 {streams[1]}, "
               f"one engine {streams['solo']}")
        expect(moved == {0: [len(prompt), 0], 1: [0, len(prompt)]},
               f"pinned ranks admitted on {moved}")

        # -1 beside a busy replica; GetLoads; rank 2
        async def busy_pick():
            long = client.generate(req(0, ids(200), DP_LONG_NEW, "long-0"))
            await long.__anext__()
            loads = await client.get_loads()
            before = _admitted(engines)
            short = ids(120)
            got = await tokens(client, -1, short, 8, "pick")
            after = _admitted(engines)
            ok = await client.abort("long-0")
            await long.aclose()
            return loads, [a - b for a, b in zip(after, before)], len(short), len(got), ok

        loads, pick_moved, n_short, n_got, ok = run(busy_pick())
        out.update(busy_loads=loads, pick_moved=pick_moved)
        expect(pick_moved == [0, n_short] and n_got == 8 and ok,
               f"-1 beside a stream on rank 0 admitted on {pick_moved} ({n_got} tokens, "
               f"abort {ok})")
        expect(len(loads["dp_queued_tokens"]) == 2 and loads["dp_queued_tokens"][0] > 0
               and loads["dp_queued_tokens"][1] == 0 and loads["num_running"] == 1,
               f"GetLoads beside the stream: {loads}")
        try:
            run(tokens(client, 2, ids(20), 2, "rank-2"))
            out["rank2_error"] = None
        except RuntimeError as e:
            out["rank2_error"] = str(e)
        expect("data_parallel_rank 2 out of range (dp_size 2)" in (out["rank2_error"] or ""),
               f"rank 2: {out['rank2_error']}")
        _quiescent(engines, "the replicas after the busy pick")

        # an abort of a rank-1 stream frees its pages there
        async def abort_rank1():
            it = client.generate(req(1, ids(400), DP_LONG_NEW, "long-1"))
            await it.__anext__()
            held = engines[1].audit()["held_pages"]
            ok = await client.abort("long-1")
            await it.aclose()
            return held, ok

        held, ok = run(abort_rank1())
        audit1 = _quiescent(engines, "replica 1 after its abort")[1]
        out["abort_rank1"] = dict(held_before=held, ok=ok, held_after=audit1["held_pages"],
                                  free_after=audit1["free_pages"])
        expect(ok and held > 0 and audit1["held_pages"] == 0 and audit1["clean"],
               f"abort on rank 1: {out['abort_rank1']}")

        # the two launch gateways in front of the two-replica worker, on the
        # server's loop (grpc.aio wants one loop a process)
        for name, flag in (("dp_aware", "--dp-aware"), ("no_dp_aware", "--no-dp-aware")):
            port = _free_port()
            args = cli.build_parser().parse_args([
                "launch", "--host", "127.0.0.1", "--port", str(port), "--worker", urls["dp"],
                flag])
            stop = asyncio.Event()
            fut = asyncio.run_coroutine_threadsafe(_run_gateway(args, stop=stop), loop)
            gateways[name] = (port, stop, fut)
        out["gateways"] = {}
        for name in ("dp_aware", "no_dp_aware"):
            port = gateways[name][0]
            _wait_http_up(port, None, f"launch {name}")
            wf = _registration(port)
            expect(wf["status"] == "completed", f"[{name}] registration {wf}")
            ranks.clear()
            res = _in_threads(lambda p: _sse(port, "/v1/chat/completions",  # noqa: B023
                                             _chat(p, 16, stream=True)),
                              [(ids(150),) for _ in range(DP_GATEWAY_STREAMS)])
            out["gateways"][name] = dict(statuses=[st for st, _ in res], ranks=list(ranks))
            _quiescent(engines, f"the replicas after {name}'s streams")
        dp_r, no_r = (out["gateways"][k]["ranks"] for k in ("dp_aware", "no_dp_aware"))
        expect(all(st == 200 for g in out["gateways"].values() for st in g["statuses"])
               and len(dp_r) == DP_GATEWAY_STREAMS and set(dp_r) == {0, 1},
               f"launch --dp-aware: {out['gateways']['dp_aware']}")
        expect(no_r == [-1] * DP_GATEWAY_STREAMS,
               f"launch --no-dp-aware: {out['gateways']['no_dp_aware']}")

        # each replica's decode column alone, then beside the other's
        lanes = lambda: [ids(200) for _ in range(DP_COLUMN_LANES)]  # noqa: E731
        dp_columns({e: lanes() for e in engines}, 16)  # warm: both captures
        alone = [dp_columns({e: lanes()}, DP_COLUMN_NEW)[0] for e in engines]
        both = dp_columns({e: lanes() for e in engines}, DP_COLUMN_NEW)
        out["columns"] = dict(alone=alone, both=both)
        print(f"  [{card}] decode column of {DP_COLUMN_LANES} lanes (float32, {PD_LAYERS} "
              f"layers): replica 0 alone {alone[0]['ms_per_column']:.3f} ms, replica 1 alone "
              f"{alone[1]['ms_per_column']:.3f} ms; both decoding: "
              f"{both[0]['ms_per_column']:.3f} and {both[1]['ms_per_column']:.3f} ms")
        audits = _quiescent(every, "every engine at the end")
        out["audits"] = [dict(held=a["held_pages"], clean=a["clean"]) for a in audits]
        expect(all(a["held_pages"] == 0 and a["clean"] and a["quiescent"] for a in audits),
               f"pages at the end: {audits}")
        stats = [dict(e.runner.stats) for e in every]
        out["launches"] = {"decode_attention": dk.launches, "prefill_attention": pk.launches}
        want = {"decode_attention": PD_LAYERS * sum(s["decode_columns"] for s in stats),
                "prefill_attention": PD_LAYERS * sum(s["prefill_calls"] for s in stats)}
        expect(out["launches"] == want and min(want.values()) > 0,
               f"launches {out['launches']} != {want}")
    finally:
        for port, stop, fut in gateways.values():
            loop.call_soon_threadsafe(stop.set)
            try:
                fut.result(60)
            except Exception as e:  # a gateway that did not stop is a failure
                failures.append(f"the launch gateway on {port} stopped with {e!r}")

        async def down():
            for c in clients.values():
                await c.close()
            for s in servers.values():
                await s.stop(grace=None)

        try:
            run(down(), timeout=60)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
            rpc_server.SchedulerServicer._engine_for = engine_for
            for e in every:
                e.stop()
    out["failures"] = failures
    out["seconds"] = time.perf_counter() - t_start
    print(f"  [{card}] dp_size {out['dp_size']}; pinned streams equal the one-engine "
          f"worker's: {out['streams_equal']}; -1 beside a stream on rank 0 admitted on "
          f"{out['pick_moved']}; GetLoads dp_queued_tokens {out['busy_loads']['dp_queued_tokens']}; "
          f"rank 2: {out['rank2_error']!r}; abort on rank 1 {out['abort_rank1']}; ranks through "
          f"launch --dp-aware {out['gateways']['dp_aware']['ranks']}, --no-dp-aware "
          f"{out['gateways']['no_dp_aware']['ranks']}; launches {out['launches']}; "
          f"phase 19's process {out['seconds']:.1f} s (setup {out['setup_s']:.1f})")
    Path(spec["report"]).write_text(json.dumps(out))
    return 1 if failures else 0


def phase_dp(dev, card: str) -> dict:
    """Phase 19: ``dp_worker_main`` in a child process on ``dev`` (Llama-3-8B,
    phase 3's config), once this one has given the card back; its report
    read."""
    import dataclasses
    import gc

    import torch

    from smg_tpu_torch.models.config import llama3_8b_config

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    spec = dict(card=card, device=str(dev), config=dataclasses.asdict(llama3_8b_config()))
    with tempfile.TemporaryDirectory(prefix="smg_dp_") as tmp:
        report = Path(tmp) / "report.json"
        sys.stdout.flush()
        code = subprocess.run([sys.executable, "-u", REPO / "chip_smoke.py", "--dp-worker",
                               json.dumps({**spec, "report": str(report)})],
                              cwd=REPO, timeout=DP_WAIT_S).returncode
        out = json.loads(report.read_text()) if report.exists() else {}
    if code != 0 or not out or out["failures"]:
        raise AssertionError(f"phase 19's process exited {code}: {out.get('failures')}")
    out["seconds_with_start"] = time.perf_counter() - t0
    print(f"  phase 19 took {out['seconds_with_start']:.1f} s ({card})")
    return out


TP_SIZE = 2  # ranks of phase 20's tp engines, both on the one card
TP_PAGES = 512  # KV pages of (a)'s float32 engines (each rank's, pinned)
TP_BF16_PAGES = 1024  # KV pages of (b)'s bf16 engines
TP_NEW = 16  # new tokens of each of (a)'s requests and (b)'s and (d)'s lanes
TP_LANES = 4  # (b)'s and (d)'s lanes
TP_PROBE_S = 90  # the NCCL probe's processes, start to exit
TP_WAIT_S = 600  # the phase's process, start to exit
TP_REFUSAL = f"needs {TP_SIZE} devices, found 1"
TP_DEVICE = "cuda:0"  # the one card every rank of phases 20-21 shares
# (a)'s float32 engines' prefill budget: phase 3's long prompt's cold first
# chunk is then 1024 tokens, which sp=2 ring-attends (bucket 1024, even)
MESH_PREFILL = 1024
# (a)'s rank meshes beside tp=1, in the order they run
MESH_F32 = {"tp2": dict(tp=2), "pp2": dict(pp=2), "pp2_tp2": dict(pp=2, tp=2),
            "sp2": dict(sp=2)}
EP_LANES = 2  # (d)'s bf16 lanes
EP_PROMPT = 64  # (d)'s first lane's prompt (the second's 40 longer)
EP_NEW = 8  # new tokens of each of (d)'s bf16 lanes
EP_PAGES = 64  # KV pages of each ep rank of (d)'s bf16 engine
# (d)'s room beside its ranks' weights: KV, the expert layer's scratch, the
# two rank processes' CUDA contexts and cuBLAS workspaces, the allocator
EP_MARGIN = 6 << 30
# the device bytes phases 20-21's engines hold at once beside phase 19's
# (~25 GB; the tensor-parallel checks alone peaked near 32 GB there), and the longest a
# build waits for its bytes
MESH_BUDGET = 44 << 30
MESH_ROOM_S = 120
RANK_OVERHEAD = 1 << 30  # a rank process's CUDA context, workspaces and allocator slack


def nccl_probe_rank(rank: int, port: int, queue) -> None:
    """One rank of the NCCL probe: join a two-rank NCCL group on ``cuda:0``
    through the store at ``port`` and all-reduce one tensor."""
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        store = dist.TCPStore("127.0.0.1", port, 2, False,
                              timeout=datetime.timedelta(seconds=60))
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = datetime.timedelta(seconds=60)
        pg = dist.ProcessGroupNCCL(dist.PrefixStore("probe", store), rank, 2, opts)
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        pg.allreduce([x]).wait()
        torch.cuda.synchronize()
        queue.put((rank, "ok", x.tolist()))
    except Exception as e:  # the refusal is the expected answer
        queue.put((rank, "error", f"{type(e).__name__}: {e}"[:600]))


def nccl_probe() -> dict:
    """Does NCCL accept two ranks on one card?  Two spawned processes try;
    whatever they say (or a hang past ``TP_PROBE_S``) is the answer, and
    both are gone before this returns."""
    import datetime
    import multiprocessing
    import queue as queues

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 2, True, timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=nccl_probe_rank, args=(r, store.port, q), daemon=True)
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    answers = {}
    deadline = time.monotonic() + TP_PROBE_S
    while len(answers) < 2 and time.monotonic() < deadline:
        try:
            rank, status, detail = q.get(timeout=1.0)
            answers[rank] = (status, detail)
        except queues.Empty:
            if all(p.exitcode is not None for p in procs):
                break
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)
    accepted = len(answers) == 2 and all(s == "ok" for s, _ in answers.values())
    errors = sorted({d for s, d in answers.values() if s != "ok"})
    return dict(accepted=accepted, answers={str(k): v for k, v in answers.items()},
                error=errors[0] if errors else (None if accepted else "no answer"),
                exit_codes=[p.exitcode for p in procs], seconds=time.perf_counter() - t0)


def _tp_engine(cfg, pages: int, tok, graphs: bool = False, overlap: bool = True,
               prefill: int = 512, **axes):
    """Phases 20-21's engine: phase 5's scheduler settings with a prefill
    budget of ``prefill``, ``pages`` KV pages a rank, weights from seed 0 (a
    rank draws them whole and keeps its part); a rank mesh of ``axes`` (tp,
    pp, sp, ep) on ``cuda:0`` repeated (gloo collectives).  ``overlap``
    off: the eager synchronous path of phase 3's ``eager`` engine."""
    from smg_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        ParallelConfig,
        SchedulerConfig,
    )
    from smg_tpu_torch.engine.engine import Engine

    par = ParallelConfig(**axes)
    ecfg = EngineConfig(
        model=cfg, parallel=par,
        cache=CacheConfig(page_size=PS, num_pages=pages, auto_size=False, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_batch_size=8, max_seq_len=4096,
                                  max_prefill_tokens=prefill, decode_horizon=4,
                                  overlap_schedule=overlap),
        decode_graphs=graphs, model_id=SERVE_MODEL)
    if par.world_size == 1:
        return Engine(ecfg, device=TP_DEVICE, tokenizer=tok)
    return Engine(ecfg, devices=[TP_DEVICE] * par.world_size, tokenizer=tok)


def _lanes_requests(seed: int, lanes: int = TP_LANES, length: int = 200):
    import numpy as np

    rng = np.random.default_rng(seed)
    first = [(f"lane{i}", rng.integers(1000, 120000, length + 40 * i).tolist())
             for i in range(lanes)]
    return lambda engine: (first, [], first[0][0])


def tp1_column_ms(engine) -> float:
    """ms a decode column of phase 20 (b)'s lanes on a tp=1 engine of the same
    weights on the eager synchronous path (``drive_engine`` times each launch
    and fetch with a sync), the reading beside (b)'s mesh ones."""
    stats = engine.runner.stats
    cols0 = stats["decode_columns"]
    _res, _steps, timers, _wall = drive_engine(engine, TP_NEW, [], loop=False,
                                               requests=_lanes_requests(20))
    return timers["decode_s"] * 1e3 / max(stats["decode_columns"] - cols0, 1)


def _gone(pid: int) -> bool:
    """No such process, or only its zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except OSError:
        return True


def _rank_launches(before: list, after: list, layers: list, rank0: dict) -> list:
    """Each rank's schedule and kernel launches between two
    ``rank_reports``, beside what its schedule implies: its ``layers[r]``
    layers x its decode columns, and x its prefill calls less those that
    ring-attended (no prefill kernel).  Rank 0 shares this process with
    other engines' rank 0: its launches (``rank0``) are those of the thread
    its steps ran on."""
    out = []
    for r0, r1, L in zip(before, after, layers):
        d = {k: r1["stats"][k] - r0["stats"][k] for k in r1["stats"]}
        out.append(dict(rank=r1["rank"], pid=r1["pid"], decode_columns=d["decode_columns"],
                        prefill_calls=d["prefill_calls"], ring_calls=d["ring_calls"],
                        launches=rank0 if r1["rank"] == 0 else
                        {k: r1["launches"][k] - r0["launches"][k] for k in r1["launches"]},
                        want={"decode_attention": L * d["decode_columns"],
                              "prefill_attention": L * (d["prefill_calls"] - d["ring_calls"])},
                        resident_bytes=r1["allocated_bytes"]))
    return out


def _stage_layers(eng) -> list:
    """Each rank's layer count, in rank order (a pipeline stage's share)."""
    par = eng.config.parallel
    return [eng.config.model.num_layers // par.pp] * par.world_size


def ring_vs_kernel(cfg, card: str) -> dict:
    """(c): ring attention over two sp rank threads on ``cuda:0`` (gloo)
    against the single-rank prefill kernel on the same bf16 chunk: the ring
    chunk's shape (``MESH_PREFILL`` tokens, the model's heads), no prefix,
    held with phase 2's bf16 tolerance."""
    import threading

    import torch

    from smg_tpu_torch.ops.cuda.prefill_attention import paged_attention_prefill_batched
    from smg_tpu_torch.parallel.group import RankGroups, connect_store, open_store
    from smg_tpu_torch.parallel.ring_attention import ring_attention

    T, H, K, D = MESH_PREFILL, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = torch.device(TP_DEVICE)
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn((1, T, n, D), generator=gen, device=dev).bfloat16()
               for n in (H, K, K))
    scale = 1.0 / math.sqrt(D)
    mp = T // PS
    kc = torch.zeros((1, mp + 1, PS, K * D), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[0, 1:] = k.reshape(mp, PS, K * D)
    vc[0, 1:] = v.reshape(mp, PS, K * D)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    want = paged_attention_prefill_batched(
        q, k.reshape(1, T, K * D), v.reshape(1, T, K * D), kc, vc, 0,
        i32([list(range(1, mp + 1))]), i32([0]), i32([T]), scale)
    store = open_store(2, 60)
    outs, errors, secs = [None, None], [], [0.0, 0.0]

    def rank(r):
        try:
            st = store if r == 0 else connect_store(store.port, 2, 60)
            groups = RankGroups(st, r, [TP_DEVICE] * 2, 60, sizes={"sp": 2})
            try:
                t0 = time.perf_counter()
                outs[r] = ring_attention(q, k, v, scale, groups.axis("sp"))
                torch.cuda.synchronize()
                secs[r] = time.perf_counter() - t0
            finally:
                groups.shutdown()
        except Exception:  # noqa: BLE001 - raised below
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=rank, args=(r,), name=f"sp-ring-{r}") for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors or any(o is None for o in outs):
        raise AssertionError(f"(c) the ring threads failed: {errors}")
    err = [check_close(f"(c) ring rank {r} vs the prefill kernel, T={T}, {H}/{K} heads",
                       outs[r], want) for r in range(2)]
    return dict(T=T, max_abs_err=max(err), ring_s=max(secs), card=card)


def _tally(thread) -> dict:
    """Kernel launches ``thread`` made so far (one engine's rank 0, when
    its steps run on that thread)."""
    from smg_tpu_torch.ops.cuda import decode_attention, prefill_attention

    return {"decode_attention": decode_attention.launches_of(thread),
            "prefill_attention": prefill_attention.launches_of(thread)}


def tp_worker_main(spec: dict) -> int:
    """Phases 20-21 in a process of its own (``--tp-worker``): the NCCL
    probe; (a) float32 parity of tp=2, pp=2, pp=2 x tp=2 and sp=2 engines
    with a tp=1 engine at full width and ``F32_LAYERS`` layers, sp=2's cold
    1024-token chunk ringed; (b) full-depth bf16 tp=2 and pp=2 engines
    serving ``TP_LANES`` lanes with per-rank launch counts held to the
    schedule, beside a tp=1 engine's reading; (c) the ring against the
    prefill kernel at that chunk; (d) Qwen3-30B-A3B at ep=2, float32 against
    ep=1 and bf16 at the greatest depth that fits; (e) ``serve --tp 2`` and
    ``serve --pp 2`` refused without a device list; (f) no rank process
    left.  The float32 checks ((a), (c), (d)'s float32) run on a thread of
    their own beside the bf16 readings ((b)), each engine's rank 0 counted
    by the thread its steps ran on.  Readings to ``spec["report"]``."""
    import dataclasses
    import gc
    import multiprocessing
    import threading

    import torch

    from smg_tpu_torch.models.config import ModelConfig
    from smg_tpu_torch.ops.cuda import build
    from smg_tpu_torch.parallel.leader import prestart
    from smg_tpu_torch.tokenizer import MockTokenizer

    from smg_tpu_torch.engine.engine import Engine  # noqa: F401 - imported before the wait

    prestart()  # the rank processes' fork server imports the port meanwhile
    card = spec["card"]
    if not await_go(spec):  # the card is not ours yet
        return 3
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        build.load()
    cfg = ModelConfig(**spec["config"])
    qcfg = ModelConfig(**spec["moe_config"])
    tok = MockTokenizer(vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_ids[0],
                        bos_token_id=cfg.bos_token_id)
    qtok = MockTokenizer(vocab_size=qcfg.vocab_size, eos_token_id=qcfg.eos_token_ids[0],
                         bos_token_id=qcfg.bos_token_id)
    failures, out, pids, timeline = [], dict(card=card), [], []
    lock = threading.Lock()

    def expect(cond, what):
        if not cond:
            failures.append(what)
            print(f"  [mesh] CHECK FAILED: {what}")

    def mark(what):
        with lock:
            timeline.append((what, round(time.perf_counter() - t_start, 2)))

    # (e) beside the rest: serve --tp 2 and --pp 2 with no device list, on a
    # one-card host
    refusal = {}

    def refuse():
        for axis in ("tp", "pp"):
            t0 = time.perf_counter()
            r = subprocess.run([*CLI, "serve", "--model-preset", SERVE_MODEL, f"--{axis}",
                                str(TP_SIZE), "--host", "127.0.0.1", "--port", str(_free_port())],
                               cwd=REPO, capture_output=True, text=True, timeout=180)
            refusal[axis] = dict(code=r.returncode, stderr_tail=r.stderr[-600:],
                                 seconds=time.perf_counter() - t0)

    refuser = threading.Thread(target=refuse, name="mesh-refusal")
    refuser.start()
    # the probe beside (a)'s tp=1 run.  Ranks that share a card take gloo
    # (parallel/group.py's rule) whatever it says; were NCCL to accept them,
    # that rule's sharing branch would have to go, which this phase reports
    probe = {}
    prober = threading.Thread(target=lambda: probe.update(nccl_probe()), name="tp-probe")
    prober.start()
    engines, backend = [], "gloo"
    out["backend"] = backend

    # the device bytes the engines of this process (and their ranks) hold
    # at once, claimed before each build and given back at each retirement:
    # phase 19 sizes its pools beside these, so they stay within
    # ``MESH_BUDGET``, and a build also waits for the card to have its bytes
    # free
    room, claimed, needs = threading.Condition(), [0], {}
    dev = torch.device(TP_DEVICE)

    def claim(key, need, budget: bool) -> None:
        t0 = time.perf_counter()
        with room:
            while ((budget and claimed[0] + need > MESH_BUDGET)
                   or torch.cuda.mem_get_info(dev)[0] < need):
                if time.perf_counter() - t0 > MESH_ROOM_S:
                    break  # build all the same: an out-of-memory error then says why
                room.wait(0.25)
            claimed[0] += need
        if time.perf_counter() - t0 > 0.5:
            mark(f"{key} waited {time.perf_counter() - t0:.1f} s for {need} bytes")

    def release(need) -> None:
        with room:
            claimed[0] -= need
            room.notify_all()

    def build(key, cfg_, *args, sized: bool = False, **kwargs):
        """``_tp_engine(cfg_, *args, **kwargs)`` on a thread of its own,
        once its bytes fit (within ``MESH_BUDGET`` unless the caller
        ``sized`` it to the free card): a mesh engine's ranks start and its
        weights are drawn beside a drive."""
        held = {"key": key}
        need = engine_bytes(cfg_, **{a: kwargs.get(a, 1) for a in ("tp", "pp", "sp", "ep")})

        def run():
            claim(key, need, budget=not sized)
            t_b = time.perf_counter()
            try:
                held["engine"] = _tp_engine(cfg_, *args, **kwargs)
                needs[id(held["engine"])] = need
            except Exception:
                held["error"] = traceback.format_exc()
                release(need)
            held["built_s"] = time.perf_counter() - t_b

        held["thread"] = threading.Thread(target=run, name=f"mesh-build-{key}")
        held["thread"].start()
        return held

    def built(held) -> object:
        held["thread"].join(TP_WAIT_S)
        if "engine" not in held:
            raise AssertionError(f"engine {held['key']} was not built: {held.get('error')}")
        eng = held.pop("engine")
        with lock:
            engines.append(eng)
        mark(f"built {held['key']} ({held['built_s']:.1f} s)")
        if eng._leader is not None:
            pids.extend(r["pid"] for r in eng._leader.rank_reports()[1:])
        return eng

    def retire(eng) -> int:
        """Close ``eng``; its claimed bytes (``settle`` them once the caller
        dropped the engine)."""
        eng.close()
        with lock:
            engines.remove(eng)
        return needs.pop(id(eng))

    def settle(need) -> None:
        """Free a retired engine's memory and give its bytes back (every
        engine here decodes eagerly: emptying the allocator's cache races no
        capture)."""
        gc.collect()
        torch.cuda.empty_cache()
        release(need)

    def f32_run(eng) -> dict:
        """(a)'s drive: phase 3's requests on the loop thread, the
        first-token logits recorded, every rank's launches read around it
        (rank 0's on the loop thread)."""
        logits: list = []
        before = eng._leader.rank_reports() if eng._leader is not None else None
        loops, start = [], eng.start

        def started(*a, **kw):
            start(*a, **kw)
            loops.append(eng._thread)

        eng.start = started
        res, _steps, _timers, wall = drive_engine(eng, TP_NEW, logits, loop=True)
        run = dict(tokens={k: r.token_ids for k, r in res.items()}, logits=logits, wall_s=wall,
                   audit=eng.audit(), keys=sorted(eng.runner.prefill_keys, key=str))
        if before is not None:
            run["per_rank"] = _rank_launches(before, eng._leader.rank_reports(),
                                             _stage_layers(eng), _tally(loops[0]))
        return run

    def hold_parity(name, a, b) -> dict:
        gaps = [float((x - y).abs().max()) for x, y in zip(a["logits"], b["logits"])]
        got = dict(identical=a["tokens"] == b["tokens"], logit_calls=len(gaps),
                   logit_gap=max(gaps) if gaps else None, wall_s=b["wall_s"])
        expect(a["tokens"] == b["tokens"]
               and all(len(t) == TP_NEW for t in a["tokens"].values()),
               f"{name} streams differ from the single rank's: "
               f"{ {k: (a['tokens'][k][:6], b['tokens'].get(k, [])[:6]) for k in a['tokens']} }")
        expect(len(a["logits"]) == len(b["logits"]) > 0 and max(gaps) <= F32_LOGIT_ATOL,
               f"{name} first-token logits: {len(a['logits'])} vs {len(b['logits'])} "
               f"calls, max gap {got['logit_gap']} (atol {F32_LOGIT_ATOL})")
        expect(b["audit"]["clean"] and b["audit"]["quiescent"], f"{name} audit {b['audit']}")
        for r in b.get("per_rank", []):
            expect(r["launches"] == r["want"] and r["want"]["decode_attention"] > 0,
                   f"{name} rank {r['rank']} launches {r['launches']} != {r['want']}")
        print(f"  [{card}] {name}, float32, {F32_LAYERS} layers: streams identical to "
              f"the single rank's: {got['identical']}; first-token logits max gap "
              f"{got['logit_gap']} over {len(gaps)} prefill calls (atol {F32_LOGIT_ATOL}); "
              f"drive {b['wall_s']:.2f} s against {a['wall_s']:.2f}")
        return got

    def full_drive(name, eng, requests, new: int = TP_NEW) -> dict:
        """A drive of ``requests`` (``new`` tokens each) on the eager
        synchronous path from this thread: every rank's launches held to its
        layers x its schedule."""
        before = eng._leader.rank_reports()
        me = threading.current_thread()
        t0 = _tally(me)
        res, _steps, timers, wall = drive_engine(eng, new, [], loop=False, requests=requests)
        rank0 = {k: v - t0[k] for k, v in _tally(me).items()}
        per_rank = _rank_launches(before, eng._leader.rank_reports(), _stage_layers(eng), rank0)
        audit = eng.audit()
        cols = per_rank[0]["decode_columns"]
        fd = dict(per_rank=per_rank, wall_s=wall, layers=eng.config.model.num_layers,
                  ms_per_column=timers["decode_s"] * 1e3 / max(cols, 1),
                  tokens={k: len(r.token_ids) for k, r in res.items()},
                  audit_clean=audit["clean"],
                  launches={k: sum(r["launches"][k] for r in per_rank)
                            for k in ("decode_attention", "prefill_attention")})
        for r in per_rank:
            expect(r["launches"] == r["want"] and min(r["want"].values()) > 0,
                   f"{name} rank {r['rank']} launches {r['launches']} != {r['want']}")
        expect(all(n == new for n in fd["tokens"].values()), f"{name} tokens {fd['tokens']}")
        expect(audit["clean"] and audit["quiescent"] and audit["leaked_pages"] == 0,
               f"{name} audit {audit}")
        return fd

    def float32_lane(held: dict) -> None:
        """(a), (c) and (d)'s float32 parity, one engine built ahead of
        the one that drives."""
        cfg32 = dataclasses.replace(cfg, num_layers=F32_LAYERS, dtype="float32")
        q32 = dataclasses.replace(qcfg, num_layers=F32_LAYERS, dtype="float32")
        f32 = {name: (lambda name=name: build(name, cfg32, TP_PAGES, tok, prefill=MESH_PREFILL,
                                              **MESH_F32[name])) for name in MESH_F32}
        f32.update({f"ep{n}": (lambda n=n: build(f"ep{n}_f32", q32, TP_PAGES, qtok, ep=n))
                    for n in (1, TP_SIZE)})
        queue = [*MESH_F32, "ep1", f"ep{TP_SIZE}"]
        one = built(build("tp1", cfg32, TP_PAGES, tok, prefill=MESH_PREFILL))
        pending = {queue[0]: f32[queue[0]]()}
        runs = held["runs"] = {"tp1": f32_run(one)}
        need = retire(one)
        del one
        settle(need)
        mark("(a) tp=1 driven")
        for i, name in enumerate(queue):
            eng = built(pending.pop(name))
            if i + 1 < len(queue):
                pending[queue[i + 1]] = f32[queue[i + 1]]()
            if name == "tp2":
                out["mesh_a"] = eng.loads(include_audit=False)["mesh"]
            runs[name] = f32_run(eng)
            need = retire(eng)
            del eng
            settle(need)
            mark(f"(a) {name} driven")
            if name == "sp2":  # (c) the ring against the prefill kernel at its chunk
                held["ring_vs_kernel"] = ring_vs_kernel(cfg, card)
                mark("(c) ring vs kernel")

    lane, lane_thread = {"runs": {}}, None
    try:
        def run_lane():
            try:
                float32_lane(lane)
            except Exception:  # noqa: BLE001 - raised on the main thread
                lane["error"] = traceback.format_exc()

        lane_thread = threading.Thread(target=run_lane, name="mesh-float32")
        lane_thread.start()
        # (b) full depth, bf16: TP_LANES lanes of TP_NEW tokens through
        # tp=2, then pp=2, then a tp=1 engine on the same seed, the same
        # eager path, in this process
        L = cfg.num_layers
        fd = out["full_depth"] = {}
        for name, axes in (("tp", dict(tp=TP_SIZE)), ("pp", dict(pp=TP_SIZE))):
            held = build(f"{name}2_bf16", cfg, TP_BF16_PAGES, tok, overlap=False, **axes)
            eng = built(held)
            got = full_drive(f"(b) {name}={TP_SIZE}", eng, _lanes_requests(20))
            got["built_s"] = held["built_s"]
            got["weight_bytes"] = [r["weight_bytes"] for r in eng._leader.rank_reports()]
            fd[name] = got
            out[f"launches_{name}"] = got["launches"]
            need = retire(eng)
            del eng
            settle(need)
            mark(f"(b) {name}={TP_SIZE} driven")
        one = built(build("tp1_bf16", cfg, TP_BF16_PAGES, tok, overlap=False))
        fd["tp1_ms_per_column"] = tp1_column_ms(one)
        need = retire(one)
        del one
        settle(need)
        mark("(b) tp=1 driven")
        stages = fd["pp"]["weight_bytes"]
        expect(max(stages) < 0.6 * sum(stages), f"(b) pp=2 stages hold {stages} weight bytes")
        print(f"  [{card}] (b) bf16, {L} layers over {backend}, eager, synchronised, beside "
              f"(a): a decode column of {TP_LANES} lanes {fd['tp']['ms_per_column']:.2f} ms at "
              f"tp={TP_SIZE}, {fd['pp']['ms_per_column']:.2f} ms at pp={TP_SIZE}, "
              f"{fd['tp1_ms_per_column']:.2f} ms at tp=1; weight bytes per tp rank "
              f"{fd['tp']['weight_bytes']}, per stage {stages}; resident per rank "
              f"{[r['resident_bytes'] for r in fd['tp']['per_rank']]} (tp), "
              f"{[r['resident_bytes'] for r in fd['pp']['per_rank']]} (pp); launches per rank "
              f"{[r['launches'] for r in fd['tp']['per_rank']]} (tp), per stage "
              f"{[r['launches'] for r in fd['pp']['per_rank']]} (pp) (readings only, {card})")
        lane_thread.join(TP_WAIT_S)
        if "error" in lane:
            raise AssertionError(f"the float32 checks failed: {lane['error']}")
        runs = lane["runs"]
        prober.join(TP_PROBE_S + 30)
        out["nccl_probe"] = probe
        print(f"  [{card}] NCCL with {TP_SIZE} ranks on {TP_DEVICE}: "
              f"{'accepted' if probe.get('accepted') else 'refused'} "
              f"({probe.get('error')}; {probe.get('seconds', 0):.1f} s)")
        expect(not probe.get("accepted"),
               f"NCCL accepted {TP_SIZE} ranks on one card: parallel/group.py's rule "
               "should give them nccl (and decode graphs), not gloo")
        out["parity_mesh"] = {name: hold_parity(f"(a) {name}", runs["tp1"], runs[name])
                              for name in MESH_F32}
        out["parity"] = out["parity_mesh"]["tp2"]
        # sp=2: phase 3's long prompt's cold first chunk (1024 tokens) rang
        sp = runs["sp2"]
        ring_keys = [k for k in sp["keys"] if k[0] == "prefill_extend" and k[5]]
        expect(any(k[1] == MESH_PREFILL for k in ring_keys),
               f"(a) sp=2 rang no cold {MESH_PREFILL}-token chunk: keys {sp['keys']}")
        out["sp"] = dict(ring_keys=ring_keys, per_rank=sp["per_rank"],
                         ring_calls=[r["ring_calls"] for r in sp["per_rank"]],
                         ring_vs_kernel=lane["ring_vs_kernel"])
        out["launches_sp"] = {k: sum(r["launches"][k] for r in sp["per_rank"])
                              for k in ("decode_attention", "prefill_attention")}
        print(f"  [{card}] (a) sp=2 ring keys {ring_keys}; ring calls a rank "
              f"{out['sp']['ring_calls']}; launches {out['launches_sp']}")
        out["ep"] = dict(parity=hold_parity(f"(d) ep={TP_SIZE}", runs["ep1"],
                                            runs[f"ep{TP_SIZE}"]))

        # (d) Qwen3-30B-A3B at full width, ep=2, bf16 at the greatest depth
        # that fits the card beside whatever runs then
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(torch.device(TP_DEVICE))[0]
        per_layer, fixed = moe_rank_bytes(qcfg)
        depth = int(min(qcfg.num_layers, (free - EP_MARGIN - TP_SIZE * fixed) // per_layer))
        expect(depth >= 1, f"(d) no bf16 layer fits beside {free} free bytes")
        qd = dataclasses.replace(qcfg, num_layers=max(depth, 1))
        held = build("ep2_bf16", qd, EP_PAGES, qtok, sized=True, overlap=False, ep=TP_SIZE)
        eng = built(held)
        fde = full_drive(f"(d) ep={TP_SIZE}", eng,
                         _lanes_requests(22, lanes=EP_LANES, length=EP_PROMPT), new=EP_NEW)
        fde["weight_bytes"] = [r["weight_bytes"] for r in eng._leader.rank_reports()]
        need = retire(eng)
        del eng
        settle(need)
        mark("(d) ep=2 bf16 driven")
        out["ep"].update(full_depth=fde, depth=depth, free_before=free, per_layer_bytes=per_layer,
                         fixed_bytes=fixed, built_s=held["built_s"])
        out["launches_ep"] = fde["launches"]
        print(f"  [{card}] (d) Qwen3-30B-A3B ep={TP_SIZE}: float32 streams identical to ep=1's: "
              f"{out['ep']['parity']['identical']}; bf16 at {depth} of {qcfg.num_layers} layers "
              f"({free} bytes free before it): weight bytes per rank {fde['weight_bytes']}, "
              f"resident {[r['resident_bytes'] for r in fde['per_rank']]}, a decode column of "
              f"{EP_LANES} lanes {fde['ms_per_column']:.2f} ms, launches per rank "
              f"{[r['launches'] for r in fde['per_rank']]}")
    finally:
        if lane_thread is not None:
            lane_thread.join(TP_WAIT_S)
        for e in list(engines):
            e.close()
    refuser.join(200)
    out["refusal"] = refusal
    for axis in ("tp", "pp"):
        r = refusal.get(axis, {})
        expect(r.get("code") not in (0, None) and TP_REFUSAL in r.get("stderr_tail", ""),
               f"(e) serve --{axis} {TP_SIZE} without devices: {r}")
        print(f"  [{card}] (e) serve --{axis} {TP_SIZE} without a device list: exit "
              f"{r.get('code')}, {r.get('stderr_tail', '').strip().splitlines()[-1:]}")
    # (f) no rank process outlives its engine
    deadline = time.monotonic() + 10
    while not all(_gone(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    stray = [p.name for p in multiprocessing.active_children()] + [
        p for p in pids if not _gone(p)]
    out["rank_pids"], out["stray"] = pids, stray
    expect(pids and not stray, f"(f) rank processes {pids}, left: {stray}")
    out["failures"] = failures
    out["timeline"] = timeline
    out["seconds"] = time.perf_counter() - t_start
    print(f"  [{card}] (f) {len(pids)} rank processes gone: {not stray}; phases 20-21's "
          f"process {out['seconds']:.1f} s; timeline {timeline}")
    Path(spec["report"]).write_text(json.dumps(out, default=str))
    return 1 if failures else 0


def engine_bytes(cfg, tp: int = 1, pp: int = 1, sp: int = 1, ep: int = 1) -> int:
    """Device bytes an engine of ``cfg`` on a mesh of these axes holds,
    bounded above: its weights in their dtype (tp and pp split them; each sp
    rank holds them whole; each ep rank holds all but its share of the
    experts) and ``RANK_OVERHEAD`` a rank.  The pinned KV pools of phases
    20-21 fall inside the overhead."""
    E, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = E * (H + 2 * K) * D + H * D * E + 2 * E
    if cfg.num_experts:
        Fm = cfg.moe_intermediate_size or cfg.intermediate_size
        dense, experts = L * (attn + E * cfg.num_experts), L * 3 * cfg.num_experts * E * Fm
    else:
        dense, experts = L * (attn + 3 * E * cfg.intermediate_size), 0
    dense += V * E * (1 if cfg.tie_word_embeddings else 2) + E
    item = 2 if cfg.dtype == "bfloat16" else 4
    return (dense * ep + experts) * sp * item + tp * pp * sp * ep * RANK_OVERHEAD


def moe_rank_bytes(cfg) -> tuple:
    """(bytes of one layer summed over the ep ranks, bytes every ep rank
    holds whole: the embedding, ``lm_head`` and the final norm) of ``cfg``
    in its dtype."""
    E, X = cfg.hidden_size, cfg.num_experts
    Fm = cfg.moe_intermediate_size or cfg.intermediate_size
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    item = 2 if cfg.dtype == "bfloat16" else 4
    attn = E * (H + 2 * K) * D + H * D * E + 2 * E + (2 * D if cfg.qk_norm else 0)
    layer = attn * TP_SIZE + E * X * TP_SIZE + 3 * X * E * Fm  # attention, router on each rank
    fixed = cfg.vocab_size * E * (1 if cfg.tie_word_embeddings else 2) + E
    return layer * item, fixed * item


class EarlyChild:
    """One phase in a process of its own (this script with ``--<flag>``),
    started ahead of its turn: it imports while the phases before it run
    and touches the card only once ``run`` lets it (``await_go``), so no
    phase before it loses memory to it or sees it in a KV sizing.  ``run``
    waits for its exit and reads its report."""

    def __init__(self, flag: str, spec: dict):
        self.tmp = Path(tempfile.mkdtemp(prefix="smg_early_"))
        self.report, self.go = self.tmp / "report.json", self.tmp / "go"
        sys.stdout.flush()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", REPO / "chip_smoke.py", f"--{flag}",
             json.dumps({**spec, "report": str(self.report), "go": str(self.go)})], cwd=REPO)

    def run(self, timeout: float) -> tuple:
        """Let it have the card; (its exit code, its report or {})."""
        self.go.touch()
        try:
            code = self.proc.wait(timeout)
            out = json.loads(self.report.read_text()) if self.report.exists() else {}
        finally:
            self.stop()
        return code, out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        shutil.rmtree(self.tmp, ignore_errors=True)


def await_go(spec: dict) -> bool:
    """In an ``EarlyChild``: wait until its parent lets it have the card
    (False past ``HANG_S``)."""
    go = spec.get("go")
    deadline = time.monotonic() + HANG_S
    while go and not Path(go).exists():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def phase_tp(dev, card: str, early: EarlyChild) -> dict:
    """Phases 20-21: ``tp_worker_main`` (Llama-3-8B, Qwen3-30B-A3B) in
    ``early``; its report read, and its rank processes checked gone once it
    exited."""
    import gc

    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    code, out = early.run(TP_WAIT_S)
    left = [p for p in out.get("rank_pids", []) if not _gone(p)]
    if code != 0 or not out or out["failures"] or left:
        raise AssertionError(f"phases 20-21's process exited {code}: "
                             f"{out.get('failures')}; rank processes left {left}")
    out["seconds_with_start"] = time.perf_counter() - t0
    print(f"  phases 20-21 took {out['seconds_with_start']:.1f} s once let go ({card})")
    return out


def tp_spec(card: str) -> dict:
    import dataclasses

    from smg_tpu_torch.models.config import ModelConfig, llama3_8b_config

    return dict(card=card, config=dataclasses.asdict(llama3_8b_config()),
                moe_config=dataclasses.asdict(ModelConfig.from_hf_config(QWEN3_30B_A3B)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    choices=("all", "kernels", "checkpoint", "moe", "api", "vision", "pd",
                             "transfer", "launch", "routing", "mesh", "responses", "messages",
                             "realtime", "train", "breadth", "dp", "tp"),
                    default="all")
    # the gRPC worker processes of phases 13 and 14, and phase 18's process:
    # this script started by itself
    ap.add_argument("--pd-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--train-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if args.pd_worker is not None:  # its device is in the spec
        sys.path.insert(0, str(REPO))
        return pd_worker_main(json.loads(args.pd_worker))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "smg_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no smg_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if args.train_worker is not None:
        return train_worker_main(json.loads(args.train_worker))
    if args.dp_worker is not None:
        return dp_worker_main(json.loads(args.dp_worker))
    if args.tp_worker is not None:
        return tp_worker_main(json.loads(args.tp_worker))
    # a hang anywhere (the card, a lock, the profiler) ends the run with
    # every thread's stack on stderr and a non-zero exit, inside the
    # 1200 s a run may take
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    failed = []
    t_run = time.perf_counter()
    card = card_line()
    print(card)
    # phase 13's worker CLI check beside the build (nvcc is host work): the
    # worker sizes its KV from the empty card and exits before phase 2
    worker_cli: dict = {}
    if args.phases in ("all", "pd"):
        cli_check = threading.Thread(
            target=lambda: worker_cli.update(value=check_worker_cli(dev.type)),
            name="worker-cli")
        cli_check.start()
    try:
        from smg_tpu_torch.ops.cuda import build

        t0 = time.perf_counter()
        lib = build.build(verbose=True)
        build.load()
        print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("phase 1 FAILED: kernels did not build")
        return 1

    if args.phases in ("all", "pd"):
        cli_check.join(LOOP_WAIT_S)
    # the side worker's CUDA context exists before any phase sizes a KV
    # cache from the free memory
    side = SideWorker()
    kernels = {}
    print("phase 2: kernels vs plain versions (bf16)")
    try:
        kernels = phase_kernels(dev)
    except Exception:
        traceback.print_exc()
        failed.append("kernels")
    engine = {}
    if args.phases in ("all", "checkpoint", "api", "pd") and not failed:
        print({"all": "phase 3: engine on Llama-3-8B (full width, 32 layers)",
               "checkpoint": "phase 8 alone, on Llama-3-8B",
               "api": "phase 10 alone, on Llama-3-8B",
               "pd": "phase 13 alone, on Llama-3-8B"}[args.phases])
        try:
            engine = {"all": lambda dev, card: phase_engine(dev, card, side,
                                                            worker_cli.get("value")),
                      "checkpoint": phase_checkpoint_alone, "api": phase_api_alone,
                      "pd": lambda dev, card: phase_pd_alone(dev, card,
                                                             worker_cli.get("value"))
                      }[args.phases](dev, card)
        except Exception:
            traceback.print_exc()
            failed.append("engine")
    moe = {}
    if args.phases in ("all", "moe") and not failed:
        print("phase 9: Qwen3-30B-A3B (full width, 48 layers, 128 experts)")
        try:
            moe = phase_moe(dev, card, side)
        except Exception:
            traceback.print_exc()
            failed.append("moe")
    vision = {}
    if args.phases in ("all", "vision", "breadth") and not failed:
        print("phase 12: Qwen2-VL-7B (full width, 28 layers, a 32-layer vision tower)"
              if args.phases != "breadth" else
              "phase 12 (d) alone: the image families, video and the families' chats on "
              "Qwen2-VL-7B (full width, 28 layers, a 32-layer vision tower)")
        try:
            vision = (phase_breadth_alone if args.phases == "breadth" else phase_vision)(
                dev, card)
        except Exception:
            traceback.print_exc()
            failed.append("vision")
    launch = {}
    if args.phases in ("all", "launch", "routing") and not failed:
        print("phase 14: launch in front of out-of-process workers (Llama-3-8B workers at "
              "full width, gRPC and HTTP; registration, drain, PD and the routing policies "
              "at 4 layers)" if args.phases != "routing" else
              "phase 14 (c) and (d) alone: registration, drain, PD, the routing policies "
              "and the HA mesh")
        try:
            launch = phase_launch(dev, card, parts=("pd",) if args.phases == "routing"
                                  else ("grpc", "http", "pd"))
        except Exception:
            traceback.print_exc()
            failed.append("launch")
    if args.phases in ("transfer", "mesh") and not failed:
        print({"transfer": "phase 13 (c) alone: PD between two gRPC worker processes by "
                           "transfer and by host (Llama-3-8B at full width, 4 layers, float32)",
               "mesh": "phase 14 (d) alone: three launch --mesh-port gateways over two gRPC "
                       "worker processes (Llama-3-8B at full width, 4 layers, float32)"
               }[args.phases])
        try:
            {"transfer": phase_transfer_alone, "mesh": phase_mesh_alone}[args.phases](dev, card)
        except Exception:
            traceback.print_exc()
            failed.append(args.phases)
    # phase 18's process imports while phases 15-17 run (``EarlyChild``); it
    # waits for its turn
    early: dict = {}
    if args.phases in ("all", "train") and not failed:
        early["train"] = EarlyChild("train-worker", {"card": card})
    # phases 20-21's process, and its rank processes' fork server, import
    # while phases 15-18 run (host work phase 18's step would feel); it waits
    # for its turn
    if args.phases in ("all", "tp") and not failed:
        early["tp"] = EarlyChild("tp-worker", tp_spec(card))
    responses = {}
    if args.phases in ("all", "responses", "messages", "realtime") and not failed:
        print({"all": "phases 15-17: the Responses API (SQLite storage, an MCP server, "
                      "approvals), then the Anthropic Messages API, a provider front and a "
                      "dedicated router, then the Realtime, Interactions and transcription "
                      "APIs and a plugin, on Llama-3-8B (full width, 32 layers)",
               "responses": "phase 15 alone: the Responses API on Llama-3-8B (full width, "
                            "32 layers; SQLite storage, an MCP server, approvals)",
               "messages": "phase 16 alone: the Anthropic Messages API, a provider front and "
                           "a dedicated router on Llama-3-8B (full width, 32 layers)",
               "realtime": "phase 17 alone: the Realtime, Interactions and transcription APIs "
                           "and a plugin on Llama-3-8B (full width, 32 layers)"
               }[args.phases])
        try:
            responses = phase_responses(dev, card, parts={
                "all": ("responses", "messages", "realtime"), "responses": ("responses",),
                "messages": ("messages",), "realtime": ("realtime",)}[args.phases])
        except Exception:
            traceback.print_exc()
            failed.append("responses")
    train = {}
    if args.phases in ("all", "train") and not failed:
        print("phases 18 and 22: the training step in a process of its own (Llama-3-8B at full "
              "width: AdamW steps in bf16, forward_train against the serving kernels in float32 "
              f"at {F32_LAYERS} layers, a tiny step on the card against the CPU; then the "
              "sharded step: dp, tp, sp, pp and dp x tp at 2 layers in float32 against one "
              "device, Qwen3-30B-A3B's ep=2 against ep=1, tp=2 and pp=2 at 32 layers in bf16)")
        try:
            train = phase_train(dev, card, early["train"])
        except Exception:
            traceback.print_exc()
            failed.append("train")
    # phases 19 and 20 side by side: each runs in a process of its own on KV
    # pools sized by hand, together well inside the card
    beside = {}
    for name, want, title, fn in (
            ("dp", ("all", "dp"), "phase 19: data-parallel replicas in one gRPC worker, in a "
             f"process of its own (two Llama-3-8B engines at full width, {PD_LAYERS} layers, "
             "float32, behind launch --dp-aware and --no-dp-aware)", phase_dp),
            ("tp", ("all", "tp"), f"phases 20-21: rank meshes in a process of its own "
             f"(Llama-3-8B at full width, {TP_SIZE} ranks an axis on one card: the NCCL probe; "
             f"float32 parity of tp, pp, pp x tp and sp with tp=1 at {F32_LAYERS} layers, the "
             f"ring against the prefill kernel; tp and pp at 32 layers in bf16; Qwen3-30B-A3B "
             f"at ep={TP_SIZE}, float32 and bf16; serve --tp and --pp refused without devices; "
             f"no rank process left)",
             lambda dev, card: phase_tp(dev, card, early["tp"]))):
        if args.phases in want and not failed:
            print(title)
            held = beside[name] = {}

            def run(fn=fn, held=held):
                try:
                    held["value"] = fn(dev, card)
                except Exception:
                    held["error"] = traceback.format_exc()

            held["thread"] = threading.Thread(target=run, name=f"phase-{name}")
            held["thread"].start()
    for name, held in beside.items():
        held["thread"].join()
        if "error" in held:
            print(f"phase {name} raised:\n{held['error']}")
            failed.append(name)
    dp = beside.get("dp", {}).get("value", {})
    tp = beside.get("tp", {}).get("value", {})
    for child in early.values():
        child.stop()  # whatever happened, its process is gone
    side.close()
    if failed:
        print(f"FAILED phases: {failed}")
        return 1
    if args.phases != "all":
        print(f"phases '{args.phases}' checked; the main path did not run whole, so no "
              "result line")
        return 0

    sources = {
        "decode_attention": ("smg_tpu_torch/csrc/decode_attention.cu",
                             "smg_tpu/ops/pallas/decode_attention.py:177"),
        "prefill_attention": ("smg_tpu_torch/csrc/prefill_attention.cu",
                              "smg_tpu/ops/pallas/prefill_attention.py:189"),
    }
    rows = []
    for name, r in kernels.items():
        src, rep = sources[name]
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            # the main path's first hop is the gateway: its HTTP run (bf16)
            launches=engine["serve_bf16"]["launches"][name],
            launches_engine=engine["launches"][name],
            # phase 7's serving path (the n-gram tier, bf16)
            launches_spec=engine["spec_bf16"]["graphs"]["launches"][name],
            # phase 8's serving path (the LoRA lanes, bf16)
            launches_ckpt=engine["ckpt_bf16"]["lora"]["launches"][name],
            # phase 9's serving path (Qwen3-30B-A3B, bf16)
            launches_moe=moe["launches"][name],
            # phase 10's graph path under the throughput mix policy (bf16)
            launches_throughput=engine["api_bf16"]["mix"]["throughput"]["launches"][name],
            # phase 12's graph path (Qwen2-VL-7B image and text requests, bf16)
            launches_vision=vision["launches"][name],
            # phase 13's PD path (bf16): prefill on the prefill engine,
            # decode on the decode engine
            launches_pd=engine["pd"]["launches"][name],
            # phase 13 (c)'s two gRPC worker processes (PD by transfer and by
            # host; float32, 4 layers), counted over their lives
            launches_transfer=engine["pd"]["grpc"]["launches"][name],
            # phase 14's two worker processes behind launch and the mesh
            # gateways (float32, 4 layers), counted in each process over its
            # life and reported at exit
            launches_launch=launch["launches"][name],
            # phase 15's three conversation turns through /v1/responses (bf16)
            launches_responses=responses["launches"][name],
            # phase 16's requests: /v1/messages, the provider front's hops and
            # the dedicated router's chats, on phase 15's engine (bf16)
            launches_messages=responses["messages"]["launches"][name],
            # phase 17's realtime sessions, interactions and plugin chats, on
            # phase 15's engine (bf16)
            launches_realtime=responses["realtime"]["launches"][name],
            # phase 18 (b)'s greedy stream that forward_train is held to
            # (float32, 4 layers), in phase 18's own process
            launches_train=train["serving"]["launches"][name],
            # phase 12 (d)'s family chats over HTTP (Qwen2-VL-7B, bf16)
            launches_breadth=vision["breadth"]["launches"][name],
            # phase 19's three engines (two replicas and a lone one; float32,
            # 4 layers), in phase 19's own process
            launches_dp=dp["launches"][name],
            # phase 20 (b)'s full-depth bf16 tp=2 drive, summed over the two
            # rank processes (each held to 32 x its decode columns and
            # prefill calls)
            launches_tp=tp["launches_tp"][name],
            # phase 21 (b)'s full-depth bf16 pp=2 drive, summed over the two
            # stages (each held to 16 x its decode columns and prefill calls)
            launches_pp=tp["launches_pp"][name],
            # phase 21 (a)'s float32 sp=2 drive (phase 3's requests), summed
            # over the two ranks; a ringed chunk launches no prefill kernel
            launches_sp=tp["launches_sp"][name],
            # phase 21 (d)'s bf16 ep=2 drive of Qwen3-30B-A3B, summed over the
            # two ranks (each held to its depth x its schedule)
            launches_ep=tp["launches_ep"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            max_err=r["max_abs_err"], kernel_ms=r["ms"], call_ms=r["call_ms"],
            plain_call_ms=r["plain_call_ms"], library_call_ms=r["library_call_ms"],
            timed_case=r["timed_case"], timed_cases=r["timed_cases"],
        ))
    print(json.dumps({"engine": engine, "moe": moe, "vision": vision, "launch": launch,
                      "responses": responses, "train": train, "dp": dp, "tp": tp,
                      "card": card}))
    print(f"the whole run took {time.perf_counter() - t_run:.1f} s ({card})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
