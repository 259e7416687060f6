"""Chip smoke test for the PyTorch/CUDA port (localai_tfp_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and exits non-zero,
after one line naming the phase (``{"phase_failed": "<name>", ...}``):

1. device  — the card's name and count, and nvidia-smi's name and power
   limit.
2. build   — nvcc builds every kernel from csrc/ (all sources at once);
   prints build seconds, each instance's -Xptxas -v registers and spill
   bytes (no instance of either kernel may spill), and the shared memory
   and resident blocks per SM of B1's instances and of B2's mixed-step
   instance.
3. kernels — ragged_paged_attention against its plain PyTorch version
   at the Llama-3.1-8B attention width (H 32,
   Hkv 8, Dh 128, page 256): the decode / prefill / mixed / verify row
   mixes with shuffled page tables, bf16 and int8 pages, and seeded
   decode; then the main path's shapes (8 slots, context 2048): a seeded
   decode step, one with every row near the context's end, a windowed
   one, a mixed step, and a mixed step with a 512-token chunk near the
   context's end, prefix sharing's aliased page tables (rows 1-5
   reading row 0's first 4 physical pages), and speculative decoding's
   ``verify`` rows (q_len 4) and ``draft_decode`` rows (seeded, Dh 64:
   the Llama-3.2-1B draft) at the decode step's contexts; every
   comparison within 1e-4
   absolute, and every call repeated bitwise. Its times are cold: each timed call reads another
   layer of a 4-layer arena, so a layer's K/V has left the L2 when its
   turn comes round. Then its time, its plain version's, SDPA's, and
   its bound. The same for the dense families' keys (``FAMILY_KEYS``):
   Gemma-3-4B's attention (H 8, Hkv 4, Dh 256) at decode and mixed rows,
   each on a global layer and a window-1024 one, Gemma-2-2B's with its
   window 4096 and softcap 50 (no single PyTorch call computes it),
   Phi-3-mini's (H 32, Hkv 32, Dh 96, window 2047) and Phi-2's (Dh 80),
   Qwen1.5-MoE's (H 16, Hkv 16, Dh 128) and Qwen3-MoE's (H 32, Hkv 4: a
   GQA group of 8), and OuteTTS-0.2-500M's (H 14, Hkv 2, Dh 64: a group
   of 7) at decode rows and at the 8B "mixed" rows.
4. int8    — int8_matmul against its plain version at every 8B
   projection shape (K x N 4096 x 4096, 4096 x 1024, 4096 x 14336,
   14336 x 4096), M in INT8_M (decode rows, the speculative verify's
   rows x n_draft, and the mixed-step instance's tile edges up to 1024),
   and at Gemma-3-4B's (``PROJ_G3``: K x N 2560 x 2048, 2560 x 1024,
   2048 x 2560, 2560 x 10240, 10240 x 2560) at M 1, 8, 17, 128 and 129,
   bf16 and f32 x, bf16 and f32 out: f32 out within 1e-4 of the largest
   output, bf16 out within one bf16 ulp of each output plus that bound;
   every call repeated bitwise. Then, cold (operand copies past
   the L2), at the INT8_TIMED shapes: the kernel by graph replay and
   call by call, its plain version, torch._weight_int8pack_mm, the bf16
   cuBLAS product over the dequantized weight, its bound and its plan,
   and for M > 16 the kernel at the row tile its plan did not pick; and
   the sum over one layer's seven projections at M = 1024
   (``layer_m1024``).
5. main    — writes a Llama-3.1-8B-geometry checkpoint (random bf16
   weights from a seed), starts the port's HTTP server in-process, sends
   concurrent streaming and non-streaming /v1/chat/completions requests,
   checks the responses, and checks that the main path launched the
   kernels (attention exactly once per layer of every forward). Then
   eight decoding requests run under torch.profiler: device busy time
   against the host clock of the decode steps, the top kernels, and
   int8_matmul's kernels by name. Twice: the bf16 model (attention
   kernel), then the same checkpoint served with ``quantization: int8``
   (both kernels), quantized on the card at a cold load, then reloaded
   from its on-disk artifact. Every non-speculative dispatch (plain
   and masked decode forwards, mixed steps) is a replay of a CUDA graph
   the worker captured at load (one per variant: row bucket, and token
   bucket for a mixed step); each replay adds the kernel launches its
   capture recorded to the counts.
   Phases 6-8 and tiers serve the bf16 model at its first
   ``CUT_LAYERS`` (8) layers and the int8 model at its first
   ``INT8_CUT_LAYERS`` (8), quantized at load with no artifact (depth
   cuts that keep the default run in its time budget; phase 5 serves both
   at full depth).
6. graphs  — on each model's server after phase 5: the burst's four
   requests in one admission wave on a fresh engine (graphs captured
   as at load) three times: by graph replay as served, with the same
   variant body run eagerly at its bucket (greedy and seeded sampled
   ids bitwise equal, and equal kernel launches: per replay against
   per call), and with the eager loop over exactly the decoding rows
   (greedy ids equal, or apart beyond a near tie only where both stay
   the dense reference's argmax); every decode forward of the served
   run a replay. Then the profile window of 8 decoding requests with
   the eager loop and with graphs (device busy share), the HTTP burst
   again, and a /metrics scrape: content type, engine_mfu_ratio in (0,
   1], engine_hbm_bytes of weights, arena, sampler and graph pool, the
   ledger's drift; warmup seconds, variants and graph-pool bytes.
7. engine  — on each model's server after phase 5: prefix sharing, six
   greedy requests behind one 1100-token system prompt (one alone, then
   five at once) on a fresh engine with sharing on and again with it off
   (prompt tokens computed, tokens reused, tail-page copies, the wave's
   TTFT, the page pool after it and leak_check, the kernels' launches);
   the greedy ids of on and off must agree except where the off run's
   top-2 logit gap at the first divergent step is below 1e-3. Then a
   raw GBNF grammar, response_format json_schema, one tool and a
   logit_bias ban, every output accepted by the port's grammar matcher,
   with the host ms of masked decode forwards beside unmasked ones; then
   a 1e-6 s timeout (504) and a deadline that expires mid-decode (200,
   finish_reason deadline_exceeded, partial text); then the on-disk
   prompt cache through the worker: the first prefix prompt (~1131
   tokens) served on a fresh engine, which saves its rows, and again on
   a fresh engine on the same weights with its graphs captured, which
   restores them in place (file bytes, save and restore wall, TTFT
   restored against cold, prompt tokens computed 1 against all, the
   restore outcomes, ids equal or dense-held); the file is removed.
8. dispatch — on each model's server after phase 7: (a) the burst's
   four prompts (28-1578 tokens) admitted while four streams decode,
   stepped by hand (one schedule) on fresh engines three times: by
   graph replay, with the same variant bodies run eagerly (ids bitwise,
   launches equal), and through the eager paths over exactly the rows
   (greedy ids equal or dense-held); every mixed step and decode
   forward of the replayed run a replay; host and device ms per mixed
   step, the padded-token share, the burst's TTFT, int8_matmul's
   launches by M; (b) phase 7's grammar and logit_bias requests by
   replay, by the bodies eagerly (outputs equal) and by the eager loop
   (host ms per masked forward); (c) a flood of four 1578-token prompts
   beside four decoding streams, without and with an ITL budget of
   twice the measured plain decode forward: the streams' delivery gaps
   (p50, p99) while the flood prefills, the token buckets chosen, the
   decode ks; (d) a request whose timeout is below its predicted
   prefill refused before any prefill (504, the reference's text), and
   a shed request's Retry-After equal to the predicted drain.
8b. tiers — on each model's server after phase 8 (the bf16 model at its
   first ``CUT_LAYERS`` layers, the int8 model at ``INT8_CUT_LAYERS``), the
   warm KV tier on a fresh engine with ``LOCALAI_KV_TIER_HOST_MB=4096``
   (pinned) and a pool of ``TIER_KV_PAGES`` (twice the default, so 8
   returning sessions stage beside 8 residents); the tier's other knobs
   at their defaults. bf16: 8 sessions of 1800 random tokens, spilled at
   once on the idle engine (bytes, ms enqueue to landed, GB/s against the
   PCIe link's bound from nvidia-smi; every plane of every session's
   host pages bitwise equal to a gather of the same pages taken before
   the spill), promoted (H2D ms and GB/s), evicted by 8 other sessions
   and served again by prefetch hit (at most 1 prompt token computed
   each), with their prefixes resident (the same ids, by replay and by
   the variant bodies: B1 launches per forward = layers both ways), and
   cold after the tier's entries are dropped (TTFT and prompt tokens of
   each way); 4 decoding streams' ITL p50/p99 with 8 returning sessions
   spilling and prefetching beside them and alone; the share of kv:*
   timeline spans overlapping step:* spans, none blocking; the cold tier
   (one session saved to a temporary ``LOCALAI_KV_TIER_DIR``, loaded
   back: file bytes, TTFT of the cold hit against a re-prefill); the
   debug routes (a traced stream's phases and echoed traceparent, a 1 s
   /debug/profile under load naming B1's kernel, /debug/timeline,
   OpenMetrics with an exemplar); the allocator's reserved bytes by
   allocation frame beside the HBM ledger. int8 (int8 pages): 2
   sessions, bytes bitwise (k, v and their scales), their hits, the
   profile naming B2's kernels too. The other phases run with the tier
   at its default (on); phases whose checks count prompt tokens or
   pages serve fresh engines whose pools stay under the tier's
   watermark, so no background spill moves their counts.
8c. weights — after phase 8b (phase 5's checkpoint; written when phase 5
   did not run): the 8B bf16 at full width and depth through the HTTP
   server with weight paging on (the default: the tree in a
   fixed-address slab, csrc/weight_vmm.cu): a greedy chat, a demotion to
   the pinned host mirror (its copy and the mirror's pinning timed),
   the same chat again after the promotion (byte-identical text, the
   same graph objects, no new variant, B1 launched on the promoted
   weights), a seed demotion (no copy) whose unmap frees at least the
   tree less one granule (mem_get_info), the TTFT hot / warm (the
   promotion included) / cold (the load); no blocking w:* span; the
   int8 8B cut at 8 layers served from its artifact (a first load
   writes it, the second reads it and seeds the pager's mirror): a seed
   demotion (no device bytes; the mirror pinned on the demotion's
   thread), the promotion from it timed, q and scale planes bitwise, B2
   launched, the text equal to the quantized load's; two models under
   LOCALAI_WEIGHT_HBM_MB sized
   for one (the idle one demoted); LOCALAI_WATCHDOG_DEMOTE=on demoting
   the idle model instead of unloading it.
8d. disagg — after 8c: the 8B bf16 at full width with LOCALAI_DISAGG off
   and on, each on its own server: eight 1800-token chats through
   /v1/chat/completions at once (greedy text equal on and off, every
   one migrated, no prompt token prefilled by the decode engine, both
   pools and the interchange leak-clean), then the same count of fresh
   prompts as a flood beside four decoding streams: TTFT, the streams'
   ITL p50/p99, the migration's device-timed D2H and H2D GB/s.
9. spec    — after phase 5 (its checkpoint):
   speculative decoding through the HTTP route with a random-weight
   Llama-3.2-1B-geometry draft (16 layers, Dh 64, tied head, seed 1)
   written beside the 8B checkpoint, n_draft 4. (a) the main burst's
   four prompts, greedy, on the 8B checkpoint's first ``SPEC_B_LAYERS``
   layers (a depth cut) with the draft and on the plain model of that
   depth: ids equal, or apart only at near ties or within the
   dense reference (``compare_waves``); (b) the 8B checkpoint's first
   ``SPEC_B_LAYERS`` (4) layers drafting for themselves (a depth cut that
   keeps the default run under its time budget), the same four at once:
   greedy ids held to the plain model of that depth as (a) holds its
   own, every greedy rejection within 0.2 of the
   verify argmax's logit, sampled (temperature 1) acceptance at least
   0.5, and two faults planted on that engine instance (a stale draft
   arena, the target's p read one position late) must each fail its
   check; (c) the int8 target (the same first ``SPEC_B_LAYERS`` layers,
   quantized at load: a depth cut that keeps the default run in its
   time budget) with the bf16 draft, one
   request and then eight at once, so its verify forwards reach
   int8_matmul at M = 4 and M = 32, the greedy ids held to the plain
   int8 model's of that depth; (d) a repeat_penalty request beside a clean one: the
   penalised row never in a speculative dispatch, both as served alone.
   In every run attention launches once per layer of every target and
   draft forward, and int8_matmul's launches equal its calls by M.
   Every speculative dispatch is a CUDA-graph replay (16 variants per
   model with a draft); each of (a) greedy, (b) greedy then sampled
   (the greedy rejection gaps read here) and (c) one then eight is also
   stepped by hand on fresh engines by replay and with the variant
   bodies run eagerly: ids bitwise equal and launches per replay equal
   to launches per call; host ms per spec dispatch by replay beside the
   bodies run eagerly and a plain decode forward; warmup seconds,
   variants and graph-pool bytes with the spec variants.
10. text   — after phase 9 (phase 5's checkpoint, and the TTFT of one
   chat request that phase 5 reads on the byte-tokenized bf16 model): the
   8B checkpoint served at full width and depth through a second model
   directory that links its weights and adds a Llama-3-layout byte-level
   BPE ``tokenizer.json`` written here without ``tokenizers`` (256 byte
   symbols, generated merges to id 128000, Llama-3's 256 special tokens,
   ``ignore_merges``), a ``tokenizer_config.json`` with
   ``clean_up_tokenization_spaces`` and a Llama-3-style chat template,
   ``generation_config.json``, and a real-YAML model config (block
   scalars, a ``trimsuffix``). A streamed chat burst (one with tools),
   a chat and a completion (echo) streamed and whole, an edit, a
   tokenize and a grammar request: the prompt ids the engine got must be
   ``encode(apply_chat_template(...), add_bos=True)``, every SSE frame a
   ``data:`` JSON object up to ``[DONE]``, the streamed text the whole
   reply's, and attention must launch. Logs the host costs (tokenizer
   load, template render, encode tokens/s cold and warm, the grammar's
   vocabulary table, stream decode per token) and the TTFT of the same
   chat request here and on the byte tokenizer. Prefix sharing is off
   for the phase, so a request served alone runs the same shapes twice.
11. lifecycle — after phase 10 (phase 5's checkpoint and int8 artifact;
   alone, ``--phases device,lifecycle`` writes the checkpoint and
   quantizes cold): one server built from an ``ApplicationConfig`` with
   an API key, single-active backend, a Machine-Tag and both watchdogs
   (0.5 s ticks) over three configs on the checkpoint at 2 slots:
   lc-bf16 (``embeddings: true``), lc-int8 and lc-bare (a directory with
   no YAML). (a) a chat without the key is 401, /healthz, /readyz,
   /metrics and /version answer without it, Machine-Tag and a sent
   X-Correlation-ID come back; (b) two concurrent first chats to lc-bf16
   load it once and agree; (c) /v1/embeddings with three inputs (the
   first repeated): 4096 finite floats each, the repeat bitwise, B1 32
   launches per forward, the first vector within 2e-2 x max|plain| of
   the same forward through the plain attention on the card; (d) a chat
   to lc-int8 evicts lc-bf16 (one single_active eviction), /system lists
   only lc-int8 with mem_get_info's device memory; (e) /backend/monitor
   200 (404 for an unknown model), /backend/shutdown; (f) the busy
   watchdog at 3 s kills a 2048-token stream (it ends with finish_reason
   "error"), no CUDA error follows, the next chat reloads, and the idle
   watchdog at 2 s unloads it; (g) a chat to lc-bare answers. After every
   unload allocated memory must be within 256 MiB of the pre-load
   baseline; the phase prints the residue and, at its end, what the
   process still holds (B1's shared merge counters, cuBLAS workspaces).

12. families — the dense families beside Llama, each from its published
   ``config.json`` with random bf16 weights, through the HTTP server
   (context 4096, 8 slots, byte tokenizer, LocalAI's Gemma Go
   template): (a) Gemma-3-4B-it at full width and depth, written as the
   multimodal checkpoint lays it out (the text tower under
   ``language_model.model.``, the SigLIP tower (27 layers, 896 px) and
   projector beside it), four streamed chats at once, one past the 1024
   window: 34 B1 launches per forward, every forward a replay, the first
   token's ms and host ms per decode forward, a greedy request held to
   the dense forward; then the image chats (``image_leg``): two PNGs in
   one streamed chat, the same text with another image, the text
   alone: every image prefill step a replay of a soft variant captured
   at load, 34 B1 launches per forward, each chat's greedy ids equal to
   the dense forward's with the same soft rows, the two image chats'
   ids different, the tower's device ms per image, first-token ms with
   images against without; then the same checkpoint with
   ``quantization: int8`` (B2 by M; its dense reference dequantizes the
   projections, so runs no B2) and its image chats; (b) Gemma-2-2B-it
   at full depth,
   whose greedy ids must also fail the dense forward without its
   softcap; (c) Phi-3-mini-4k at 8 of its 32 layers (fused
   projections). Every line beside nvidia-smi's name and power limit.

13. moe    — (runs after phase 4, before phase 5: each checkpoint is
   removed before the next is written, so the disk never holds one
   beside the 8B phases' files) the mixtures of experts, each from its
   published
   ``config.json`` with random bf16 weights, through the HTTP server
   (context 4096, 8 slots, byte tokenizer): (a) Qwen1.5-MoE-A2.7B-Chat at
   full width and 8 of its 24 layers (60 experts, top-4 raw weights, a
   sigmoid-gated shared expert; a depth cut of the run's time, 28.6 GB at
   all 24) and (b) Qwen3-30B-A3B at full
   width, 8 of its 48 layers (128 experts, top-8 renormalized, q/k norms):
   four streamed chats at once, one past 1024 prompt tokens, B1 once per
   layer of every forward, every forward a replay, a greedy request held
   to the dense forward; one layer's expert block against a per-token loop
   over each token's routed experts (and the shared expert) within 3% of
   the largest output, the same expert sets but at router near ties; the
   decode profile of (a). Each checkpoint is dropped after it is served.
14. gguf   — (after phase 13, its files removed in turn too) GGUF files
   written here (random blocks with sane scales, no
   quantizer) and served with their own tokenizer and chat template: (a)
   a Llama-3.1-8B-geometry file at full width and depth in llama.cpp's
   Q4_K_M mix with a 128256-token byte-level BPE vocabulary (the card's
   dequantization of one tensor per type bitwise equal to the CPU's, the
   Q/K rows un-permuted as convert_hf_to_gguf permutes them, the prompt
   ids equal to encode(apply_chat_template(...))), (b) the same file with
   a rank-16 PEFT adapter at scale 0.5 (one merged leaf within one bf16
   unit of W + delta in f64 on the host; after remove_lora and apply_lora
   on the running engine the same greedy ids), (c) the same file with
   ``quantization: int8`` (B2 by M), (d) a Mixtral-8x7B-Instruct-geometry
   file, 4 of its 32 layers, Q4_K experts, a 32000-piece sentencepiece
   vocabulary with byte fallback (its expert block checked as in phase
   moe). Each leg as in phase moe: four streamed chats (one past 1024
   prompt tokens), B1 once per layer of every forward, every forward a
   replay, a greedy request held to the dense forward.

16. recurrent_vision — (after phase 12) (a) LLaVA-1.5-7B: the CLIP
   ViT-L/14-336 tower at full depth (24 layers, 576 soft tokens an
   image) and the Llama-2-7B decoder at full width, 4 of its 32 layers,
   through the HTTP server: an image chat as phase 12's burst, then
   ``image_leg``'s chats (4 B1 launches per forward); (b) Mamba-2.8B at
   8 of 64 layers (bf16) and (c) RWKV-4-3B at 8 of 32 layers (f32): a
   streamed chat each, its greedy ids equal to the step function run
   eagerly on the same prompt (every step a replay of the step graph),
   host ms per token by replay and eagerly, load s, peak memory. Every
   depth cut is the line's ``reduced``.

15. retrieval — (last) the encoder workers and the vector stores through
   the HTTP server, from BERT checkpoints written here with random f32
   weights from the seed at published geometries, each with a
   30522-entry WordPiece ``tokenizer.json`` generated here: (a)
   sentence-transformers/all-MiniLM-L6-v2 (6 layers, d 384, 12 heads)
   behind ``backend: sentencetransformers``, /v1/embeddings of 32 texts
   of 3-700 tokens (every bucket, three cut at 512): unit norms, each
   vector within 1e-4 of the port's CPU forward; load s, the request's
   wall, tokens/s, device ms per encode at each bucket (CUDA events,
   eager and by graph replay); (b) BAAI/bge-large-en-v1.5's geometry (24
   layers, d 1024, 16 heads, 1.34 GB f32), the same checks on 12 texts,
   one 512-token encode against its f32 FLOP bound, and after
   /backend/shutdown the allocated bytes back at the pre-load baseline;
   (c) /v1/rerank of a query and 20 documents (top_n 5) on
   cross-encoder/ms-marco-MiniLM-L-6-v2's geometry (a pooler, one label)
   and on (a)'s checkpoint as a bi-encoder: scores within 1e-4 of the CPU
   forward, the order equal where neighbouring scores differ by more,
   usage equal to the tokenizer's count; (d) 100 000 unit-norm keys of
   width 384 in the native store and in the Python store (its matvec on
   the card above 50 000 rows), a few through /stores/set: finds of top
   10 through the route equal in keys, values and order, similarities
   within 1e-5 of a numpy f64 scan; each find's ms, the Python store's
   key copy and matvec. Neither kernel runs here: the JAX encoder and
   store have no Pallas kernel.

17. audio — (after phase 15) audio in through the HTTP server: a
   checkpoint at openai/whisper-large-v2's geometry (d_model 1280, 32 + 32
   layers, 20 heads, ffn 5120, 80 mel bins, vocab 51865; random f32
   weights from the seed, 6.2 GB) with a byte-level BPE
   ``tokenizer.json`` in Whisper's special-token layout, behind
   ``backend: whisper``: a 12 s 16 kHz mono WAV through
   /v1/audio/transcriptions in each response format (the same text in
   every format) and a 45 s 44.1 kHz stereo one (two chunks, resampled;
   ``language: de``, ``translate``) in verbose_json (one segment a
   chunk, the text the segments' texts joined); the served decoder (one
   encoder replay a chunk, one replay a token, 224 picks) against the
   plain full-recompute decoder on the card (its first 64 ids equal, or
   within 1e-3 as below) and every served pick within 1e-3 of the
   argmax of the plain decoder's teacher-forced logits; the encoder by
   replay against eagerly (within 1e-4); encoder
   device ms a chunk, decoder host ms a token by replay and eagerly,
   host log-mel ms a chunk, each request's wall ms and real-time factor,
   the graph pool's bytes. Then a silero-v5-geometry VAD (random; its
   head scaled and biased so the audio's voiced chunks' logits average
   +3 and its quiet chunks' -3) behind ``backend: silero-vad``: /v1/vad
   over 60 s (1875 chunks), the probabilities above 0.5 and below 0.35
   somewhere, more than one segment, the route's segments those of the
   served probabilities (one batched front end, one replay a block of 64
   LSTM steps), which are within 1e-4 of the chunk-by-chunk loop; each
   one's ms. Neither kernel runs here: the JAX audio networks have no
   Pallas kernel.
18. tts — (after phase 17) speech out through the HTTP server at
   published widths, random weights from the seed (``phase_tts``):
   facebook/mms-tts-eng's VITS (16 kHz, its character tokenizer), a
   piper voice at jaywalnut310/vits ljs_base's widths (22050 Hz, the
   fallback phonemizer), Kokoro-82M with one voice pack (24 kHz) and
   OuteTTS-0.2-500M's LM at Qwen2.5-0.5B's widths (24 layers, 14 query
   heads over 2 KV heads of 64) over encodec_24khz's decoder, each behind
   its YAML through /v1/audio/speech, /tts (the config's ``tts.voice``)
   and /v1/text-to-speech/{voice}: 200, ``audio/x-wav``, the rate in the
   header, request ms and real-time factor; each model against the same
   model on the CPU with the same noise (VITS/piper: numpy draws,
   durations equal; Kokoro: one injected source-noise sample, durations
   equal) within 1e-3 of max|CPU| (TF32 off), its served samples within
   one int16 unit of its own card waveform; OuteTTS's greedy picks held
   to the dense forward and its codes decoded against the CPU's codec;
   device ms by stage; after each unload the allocated bytes back within
   256 MiB of the baseline. The formant voice and /v1/sound-generation's
   noise bands give the host's bytes. B1 runs in OuteTTS's LM
   (``launches_tts``); VITS, piper and Kokoro have no Pallas kernel in the
   JAX package.
19. tts_ar — (after phase 18) the autoregressive speech and sound
   families at published widths, random weights from the seed
   (``phase_tts_ar``): suno/bark-small's three GPTs over encodec_24khz,
   coqui/XTTS-v2 (30 x 1024 GPT-2, HiFiGAN x256, one voice, a
   ``Whitespace`` vocab.json) and facebook/musicgen-small (t5-base,
   24 x 1024 decoder, 4 codebooks, encodec_32khz), each behind its YAML:
   bark at the worker's defaults by /tts and greedy by /v1/audio/speech
   (256 semantic tokens, the coarse window sliding past 1024), XTTS by
   /v1/audio/speech, /tts and /v1/text-to-speech/ana, MusicGen at 5 s
   with guidance by /v1/sound-generation, sampled and greedy; request ms
   and real-time factor, host ms a token and device ms by stage; every
   greedy stage's picks held to a teacher-forced forward of the same
   model on the CPU (argmax count, worst deficit under a quarter of the
   logits' std), the card's codes or latents decoded on the CPU within
   1e-4 of max|CPU| (TF32 off), served samples within one int16 unit of
   the card's waveform; after each unload the allocated bytes back
   within 256 MiB of the baseline. Neither kernel runs
   (``launches_tts_ar``): the JAX package's bark, XTTS and MusicGen
   loops reach no Pallas kernel.

Not in the default list: ``softcap_witness`` — Gemma-2-2B at full depth
with every layer's q_proj at 4x and at 1x the softcap: the served greedy ids
against the dense forward in bf16 and in f32, and one paged forward
through B1 against the same forward with the plain attention.

The last line of standard output is the result object; the line before
it lists every kernel with its numbers.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CARD = "cuda"  # where phases families, moe and gguf make and serve models

# the 8B model's attention geometry (Llama-3.1-8B config.json)
H, HKV, DH, PAGE = 32, 8, 128, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
# The JAX harness's bounds (localai_tfp_tpu/ops/kernel_check.py) hold a
# bf16 Pallas kernel against an f32 reference. Here the kernel and its
# plain version both compute in f32 from the same bf16/int8 values, so the
# check fails at a far tighter absolute bound: 1e-4 is well below what a
# wrong mask, seed row or page (>= ~3e-4 at ctx 2048) moves an output.
JAX_TOL = {"bf16": 2e-2, "int8": 5e-2}
TOL = 1e-4


T0 = time.perf_counter()


def log(phase: str, **kw) -> None:
    """One result line; ``t_s`` is the script's elapsed seconds."""
    print(json.dumps({"phase": phase,
                      "t_s": round(time.perf_counter() - T0, 3), **kw}),
          flush=True)


def require_package():
    if not (ROOT / "localai_tfp_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         "(localai_tfp_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))


# ------------------------------------------------------------------ phase 1


def phase_device():
    import torch

    from localai_tfp_tpu_torch.device import describe

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = describe()
    log("device", **dev, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)
    return dev, smi


# ------------------------------------------------------------------ phase 2


def phase_build():
    from localai_tfp_tpu_torch.models import weight_slab
    from localai_tfp_tpu_torch.ops import _build, int8_matmul
    from localai_tfp_tpu_torch.ops import ragged_paged_attention as rpa

    t0 = time.perf_counter()
    # the two kernels and the weight slab's cuMem* calls, one nvcc each,
    # all started together
    built = _build.build_all([rpa.KERNEL, int8_matmul.KERNEL,
                              weight_slab.KERNEL])
    report = {}
    for name, b in built.items():
        report[name] = ptxas_summary(b.ptxas)
        log("build", kernel=name, nvcc_s=round(b.seconds, 3),
            wall_s=round(time.perf_counter() - t0, 3), ptxas=report[name])
    occ = rpa.occupancy()
    log("build_occupancy", kernel=rpa.KERNEL, instances=occ)
    occ8 = int8_matmul.occupancy()
    log("build_occupancy", kernel=int8_matmul.KERNEL, instances=occ8)
    for name in (rpa.KERNEL, int8_matmul.KERNEL):
        spilled = [r for r in report[name] if r["spill_bytes"]]
        if spilled:
            raise AssertionError(f"{name} spills registers: {spilled}")
    return report, occ, occ8


def ptxas_summary(text: str) -> list[dict]:
    """Per kernel instance: registers and spill bytes from -Xptxas -v."""
    import re

    def short(entry: str) -> str:
        # rpa_kernel<QT, KT, DH, BM> as "q/kv/dh/bm"
        m = re.search(r"rpa_kernelI(13__nv_bfloat16|f)(S1_|a|f)Li(\d+)ELi(\d+)E",
                      entry)
        if not m:
            # i8mm_<name><BM> as "i8mm_<name> bm BM"
            m = re.search(r"(i8mm_[a-z0-9]+)(?:ILi(\d+)E)?", entry)
            if not m:
                return entry
            return m.group(1) + (f" bm {m.group(2)}" if m.group(2) else "")
        q = "bf16" if m.group(1) != "f" else "f32"
        kv = {"S1_": "bf16", "a": "i8", "f": "f32"}[m.group(2)]
        return f"rpa q {q} kv {kv} dh {m.group(3)} bm {m.group(4)}"

    rows = []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            rows.append({"entry": short(m.group(1)), "registers": None,
                         "spill_bytes": 0})
        elif rows and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            rows[-1]["spill_bytes"] = int(st) + int(ld)
        elif rows and "Used" in ln and "registers" in ln:
            rows[-1]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return rows


# ------------------------------------------------------------------ phase 3


def make_case(mix: str, quant: bool, seeded: bool, *, B: int, max_pages: int,
              seed: int, L: int = 2, window=None, dh: int = DH, pos0=None):
    """Inputs in the style of localai_tfp_tpu/ops/kernel_check.py
    check_ragged_attention: shuffled page tables over a shared arena, at
    the 8B attention width, on the card. ``chunk512`` is the main path's
    mixed step at its fullest: a 512-token prefill chunk (the engine's
    chunk at 8 slots) beside decode, verify and shorter chunk rows, every
    row ending within 64 tokens of the context's end; ``decode_long``
    a decode step whose every row ends within 160 tokens of it;
    ``aliased`` prefix sharing's tables: rows 1-5 alias row 0's first 4
    physical pages (a 1024-token shared prefix) and then read their own
    pages, as decode rows and suffix prefill chunks past the prefix;
    ``draft_decode`` decode rows at the draft's head dim ``dh`` 64. ``L``
    layers of arena; the call reads layer 1, or ``layer`` as cycled by
    the timing. ``pos0`` replaces the rows' drawn start positions."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models.transformer import _quantize_rows

    rng = np.random.default_rng(seed)
    kd = 4
    if mix in ("decode", "decode_long", "draft_decode"):
        q_lens = np.ones(B, np.int32)
    elif mix == "prefill":
        q_lens = rng.integers(2, 257, B).astype(np.int32)
    elif mix == "verify":
        q_lens = np.full(B, kd, np.int32)
    elif mix == "chunk512":
        q_lens = np.resize(np.asarray([512, 1, 1, 7, kd, 64, 1, 300],
                                      np.int32), B)
    elif mix == "aliased":
        q_lens = np.resize(np.asarray([1, 40, 1, 23, 60, 1, 1, 128],
                                      np.int32), B)
    else:  # decode rows + chunks + one verify row together
        q_lens = np.resize(np.asarray([1, 1, 7, 256, kd, 64], np.int32), B)
    T = int(q_lens.max())
    cap = max_pages * PAGE
    near = {"chunk512": 64, "decode_long": 160}.get(mix)
    lo = (lambda n: cap - n - near) if near else (lambda n: 0)
    drawn = np.asarray([int(rng.integers(lo(int(n)), cap - int(n) + 1))
                        for n in q_lens], np.int32)
    pos0 = drawn if pos0 is None else np.asarray(pos0, np.int32)
    n_pages = B * max_pages + 1
    pt = rng.permutation(np.arange(1, n_pages)).reshape(
        B, max_pages).astype(np.int32)
    if mix == "aliased":  # every row past the 1024-token shared prefix
        pos0 = np.resize(np.asarray([1500, 1100, 1180, 1076, 1090, 1300,
                                     700, 0], np.int32), B)
        pt[1:6, :4] = pt[0, :4]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    F = HKV * dh
    ak = torch.randn((L, n_pages, PAGE, F), generator=g, device=dev) * 0.5
    av = torch.randn((L, n_pages, PAGE, F), generator=g, device=dev) * 0.5
    # logits with a std of about 0.5, so the softmax is not near uniform
    q = torch.randn((B, T, H, dh), generator=g, device=dev).to(torch.bfloat16)
    case = {
        "q": q, "layer": 1, "n_kv_heads": HKV, "scale": dh ** -0.5,
        "page_table": torch.from_numpy(pt).to(dev),
        "pos0": torch.from_numpy(pos0).to(dev),
        "q_lens": torch.from_numpy(q_lens).to(dev), "window": window,
    }
    if quant:
        kq, ks = _quantize_rows(ak)
        vq, vs = _quantize_rows(av)
        case.update(cache_k=kq, cache_v=vq, cache_k_scale=ks,
                    cache_v_scale=vs)
    else:
        case.update(cache_k=ak.to(torch.bfloat16),
                    cache_v=av.to(torch.bfloat16))
    if seeded:
        case["seed_kv"] = (
            (torch.randn((B, F), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16),
            (torch.randn((B, F), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16))
    return case


def _call(fn, c):
    return fn(c["q"], c["cache_k"], c["cache_v"], c["layer"],
              c["page_table"], c["pos0"], c["q_lens"], c["n_kv_heads"],
              scale=c["scale"], page=PAGE, sliding_window=c["window"],
              softcap=c.get("softcap", 0.0),
              cache_k_scale=c.get("cache_k_scale"),
              cache_v_scale=c.get("cache_v_scale"),
              seed_kv=c.get("seed_kv"))


def attention_work(c) -> tuple[int, int]:
    """(bytes, flops) the call must do on these inputs: q, out and each
    row's live K/V rows (and scales) within its window read or written
    once; 4 flops per (query, kv position, head dim) pair actually
    attended."""
    q_lens = c["q_lens"].tolist()
    pos0 = c["pos0"].tolist()
    elem = c["cache_k"].element_size()
    h, dh = c["q"].shape[2], c["q"].shape[3]
    F = c["n_kv_heads"] * dh
    w = c["window"] or 0
    nbytes = c["q"].numel() * c["q"].element_size()  # q in
    nbytes += c["q"].shape[0] * c["q"].shape[1] * h * dh * 4  # out f32
    nbytes += c["page_table"].numel() * 4 + 8 * len(q_lens)
    flops = 0
    for n, p0 in zip(q_lens, pos0):
        live = p0 + n - (max(0, p0 + 1 - w) if w and n else 0)
        nbytes += 2 * live * F * elem
        if "cache_k_scale" in c:
            nbytes += 2 * live * 4
        attended = sum(min(p0 + t + 1, w) if w else p0 + t + 1
                       for t in range(n))
        flops += 4 * h * dh * attended
    return nbytes, flops


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
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


def _library_call(c):
    """One PyTorch call computing the same attention: scaled_dot_product_
    attention over each row's gathered [B, H, W, Dh] window with the
    causal/ragged mask (gather and mask built outside the timed call).
    Used here as a yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as Fnn

    B, T, _, dh = c["q"].shape
    hkv = c["n_kv_heads"]
    pt = c["page_table"].long()
    W = pt.shape[1] * PAGE
    k = c["cache_k"][c["layer"]][pt].reshape(B, W, hkv, dh)
    v = c["cache_v"][c["layer"]][pt].reshape(B, W, hkv, dh)
    if "cache_k_scale" in c:
        ks = c["cache_k_scale"][c["layer"]][pt].reshape(B, W, 1, 1)
        vs = c["cache_v_scale"][c["layer"]][pt].reshape(B, W, 1, 1)
        k, v = k.float() * ks, v.float() * vs
    k = k.to(torch.bfloat16).transpose(1, 2).contiguous()
    v = v.to(torch.bfloat16).transpose(1, 2).contiguous()
    q = c["q"].transpose(1, 2).contiguous()
    kv_pos = torch.arange(W, device=q.device)
    tq = torch.arange(T, device=q.device)
    qpos = c["pos0"].long()[:, None] + tq[None]
    mask = (kv_pos[None, None] <= qpos[..., None]) & (
        tq[None, :, None] < c["q_lens"].long()[:, None, None])
    if c["window"]:
        mask &= kv_pos[None, None] > qpos[..., None] - c["window"]
    mask = mask | ~mask.any(-1, keepdim=True)  # keep pad rows finite
    mask = mask[:, None]

    def run():
        return Fnn.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)

    return run


ATTN_LAYERS = 4  # arena depth of the timed cases: see _layers


def _layers(c):
    """The case at each layer of its arena, in turn, as a decode step
    walks its layers: a decode step's live K/V (~30 MB a layer at the
    main path's shapes) is cold again when its layer comes round, since
    the other layers' (~90 MB) pass through the 50 MB L2 in between."""
    return [({**c, "layer": i},) for i in range(ATTN_LAYERS)]


def phase_kernels(n_slots: int, max_pages: int):
    import torch

    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_attention_plain, ragged_paged_attention,
    )

    # the four row mixes on a small arena, then the main path's shapes
    # (every slot, the full context): a seeded decode step, a seeded
    # decode step with every row near the context's end (the longest
    # split ranges), a windowed seeded decode step (window edges inside
    # splits, whole splits outside), a mixed step with and without a
    # window (its chunk rows see the window's edge move), a step with
    # the engine's 512-token chunk near ctx 2048, and speculative
    # decoding's verify rows (q_len 4) and draft rows (the Llama-3.2-1B
    # draft's Dh 64, seeded) at the decode step's contexts
    small = [(mix, seeded, 6, 4, None)
             for mix in ("decode", "prefill", "mixed", "verify")
             for seeded in ((False, True) if mix == "decode" else (False,))]
    full = [(mix, seeded, n_slots, max_pages, window)
            for mix, seeded, window in (
                ("decode", True, None), ("decode_long", True, None),
                ("decode", True, 300), ("mixed", False, None),
                ("mixed", False, 300),
                ("chunk512", False, None), ("aliased", False, None),
                ("verify", False, None), ("draft_decode", True, None))]
    worst = {"bf16": 0.0, "int8": 0.0}
    decode_ctx = None  # the timed decode step's contexts
    aliased = {}  # the aliased-table case's error by page type
    spec_err = {}  # the speculative keys' errors by page type
    timed = {}  # the full-shape bf16 cases, timed below
    for mix, seeded, B, pages, window in small + full:
        for quant in (False, True):
            seed = len(mix) + 10 * quant + 100 * seeded + B
            is_timed = (B == n_slots and window is None and not quant
                        and mix not in ("decode_long", "aliased"))
            spec_key = B == n_slots and mix in ("verify", "draft_decode")
            pos0 = None
            if spec_key:
                n = 4 if mix == "verify" else 1
                pos0 = [max(0, ctx - n) for ctx in decode_ctx]
            c = make_case(mix, quant, seeded, B=B, max_pages=pages,
                          seed=seed, window=window,
                          L=ATTN_LAYERS if is_timed else 2,
                          dh=64 if mix == "draft_decode" else DH, pos0=pos0)
            if is_timed:
                timed[mix] = (c, seeded)
                if mix == "decode":
                    decode_ctx = [p + 1 for p in c["pos0"].tolist()]
            got = _call(ragged_paged_attention, c)
            want = _call(ragged_attention_plain, c)
            again = _call(ragged_paged_attention, c)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            repeat = bool(torch.equal(got, again))
            kind = "int8" if quant else "bf16"
            worst[kind] = max(worst[kind], err)
            if mix == "aliased":
                aliased[kind] = err
            if spec_key:
                spec_err[f"{mix}_{kind}"] = err
            log("kernel_check", kernel="ragged_paged_attention", mix=mix,
                pages=kind, seeded=seeded, window=window, rows=B,
                max_pages=pages, q_lens=c["q_lens"].tolist(),
                ctx=[p + n for p, n in zip(c["pos0"].tolist(),
                                           c["q_lens"].tolist())],
                head_dim=c["q"].shape[-1],
                max_abs_err=err, max_abs_want=float(want.abs().max()),
                tol=TOL, jax_harness_tol=JAX_TOL[kind],
                bitwise_repeat=repeat)
            if not err < min(TOL, JAX_TOL[kind]):
                raise AssertionError(
                    f"ragged_paged_attention {mix}/{kind}/seeded={seeded} "
                    f"window={window} B={B}: max abs err {err} >= {TOL}")
            if not repeat:
                raise AssertionError(
                    f"ragged_paged_attention {mix}/{kind}: two calls on the "
                    "same inputs differ")
    # timing at the main path's shapes, bf16 pages as the engine serves,
    # each call on a cold layer (_layers)
    timings = {}
    for mix, (c, seeded) in timed.items():
        B = c["q"].shape[0]
        nbytes, flops = attention_work(c)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / BF16_FLOPS else "operations")
        sets = _layers(c)
        before = ragged_paged_attention.launches
        ms = _time_graph(_cycled(
            lambda c: _call(ragged_paged_attention, c), sets), 48)
        # the same calls launched one by one from Python, as the engine
        # launches them today
        eager_ms = _time_ms(_cycled(
            lambda c: _call(ragged_paged_attention, c), sets), 48)
        ragged_paged_attention.launches = before  # timing is not the path
        plain_ms = _time_ms(_cycled(
            lambda c: _call(ragged_attention_plain, c), sets), 8)
        lib_runs = [_library_call(cl) for (cl,) in sets]
        library_ms = _time_graph(_cycled(lambda run: run(),
                                         [(r,) for r in lib_runs]), 24)
        del lib_runs
        timings[mix] = {
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            "rows": B, "q_lens": c["q_lens"].tolist(),
            "ctx": [p + n for p, n in zip(c["pos0"].tolist(),
                                          c["q_lens"].tolist())],
            "layers_cycled": ATTN_LAYERS,
        }
        log("kernel_time", kernel="ragged_paged_attention", mix=mix,
            seeded=seeded, **timings[mix])
    return worst, timings, aliased, spec_err


# B1 at the families' attention geometries (the published config.json
# values): (key, H, Hkv, Dh, window, softcap, rows, max pages)
FAMILY_KEYS = (
    ("g3_decode", 8, 4, 256, 0, 0.0, "decode", 8),  # Gemma-3-4B global
    ("g3_decode_local", 8, 4, 256, 1024, 0.0, "decode", 8),  # its sliding
    ("g3_mixed", 8, 4, 256, 0, 0.0, "mixed", 8),
    ("g3_mixed_local", 8, 4, 256, 1024, 0.0, "mixed", 8),
    ("g2_softcap", 8, 4, 256, 4096, 50.0, "decode", 8),  # Gemma-2-2B
    ("phi3_decode", 32, 32, 96, 2047, 0.0, "decode", 16),  # Phi-3-mini-4k
    ("phi2_decode", 32, 32, 80, 0, 0.0, "decode", 8),  # Phi-2
    ("qwen2moe_decode", 16, 16, 128, 0, 0.0, "decode", 8),  # Qwen1.5-MoE
    ("qwen3moe_decode", 32, 4, 128, 0, 0.0, "decode", 8),  # a GQA group 8
    # OuteTTS-0.2-500M's LM (Qwen2.5-0.5B): a GQA group of 7, whose
    # 64-row tiles hold 64 / 7 positions (one straddles two tiles)
    ("oute_decode", 14, 2, 64, 0, 0.0, "decode", 8),
    ("oute_mixed", 14, 2, 64, 0, 0.0, "mixed8b", 8),  # the 8B "mixed" rows
)


def family_case(key: tuple, quant: bool, seed: int, L: int) -> dict:
    """B1's inputs at a family key: 8 rows of bf16 queries over a shuffled
    bf16 or int8 arena of page 256. ``decode``: seeded decode rows at
    contexts 144 .. 1831 (3900 where the arena holds 4096 tokens);
    ``mixed``: six of those decode rows beside a 512-token chunk at
    1100 (across the 1024 window) and a 64-token chunk at 1700;
    ``mixed8b``: the 8B "mixed" q_lens (1, 1, 7, 256, 4, 64, 1, 1) ending
    at those contexts. The softcap key's queries are scaled so the logits
    reach the cap."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models.transformer import _quantize_rows

    _, h, hkv, dh, window, cap, rows, max_pages = key
    B = 8
    ctx = np.linspace(144, 1831 if max_pages == 8 else 3900,
                      B).astype(np.int32)
    if rows == "decode":
        q_lens, pos0 = np.ones(B, np.int32), ctx - 1
    elif rows == "mixed8b":  # make_case's "mixed" q_lens at these contexts
        q_lens = np.resize(np.asarray([1, 1, 7, 256, 4, 64], np.int32), B)
        pos0 = (ctx - q_lens).astype(np.int32)
    else:
        q_lens = np.asarray([1] * 6 + [512, 64], np.int32)
        pos0 = np.concatenate([ctx[:6] - 1, [1100, 1700]]).astype(np.int32)
    rng = np.random.default_rng(seed)
    n_pages = B * max_pages + 1
    pt = rng.permutation(np.arange(1, n_pages)).reshape(
        B, max_pages).astype(np.int32)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    F = hkv * dh
    ak = torch.randn((L, n_pages, PAGE, F), generator=g, device=dev) * 0.5
    av = torch.randn((L, n_pages, PAGE, F), generator=g, device=dev) * 0.5
    T = int(q_lens.max())
    q = torch.randn((B, T, h, dh), generator=g, device=dev)
    if cap:
        q = q * 40  # logits of std ~20 against a cap of 50
    c = {"q": q.to(torch.bfloat16), "layer": 1, "n_kv_heads": hkv,
         "scale": dh ** -0.5, "window": window, "softcap": cap,
         "page_table": torch.from_numpy(pt).to(dev),
         "pos0": torch.from_numpy(pos0).to(dev),
         "q_lens": torch.from_numpy(q_lens).to(dev)}
    if quant:
        kq, ks = _quantize_rows(ak)
        vq, vs = _quantize_rows(av)
        c.update(cache_k=kq, cache_v=vq, cache_k_scale=ks, cache_v_scale=vs)
    else:
        c.update(cache_k=ak.to(torch.bfloat16), cache_v=av.to(torch.bfloat16))
    if rows == "decode":
        c["seed_kv"] = tuple((torch.randn((B, F), generator=g, device=dev)
                              * 0.5).to(torch.bfloat16) for _ in range(2))
    return c


def family_kernel_keys() -> tuple[float, dict]:
    """Every FAMILY_KEYS key against the plain version within 1e-4 (bf16
    and int8 pages, each call repeated bitwise), then timed cold on bf16
    pages as the main keys are: by CUDA-graph replay (``ms``) and call by
    call (``eager_ms``), beside the plain version, the bound and SDPA
    over the gathered window with the same mask (none for the softcap:
    SDPA has no softcap, so no single call computes it)."""
    import torch

    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_attention_plain, ragged_paged_attention,
    )

    worst, out = 0.0, {}
    for i, key in enumerate(FAMILY_KEYS):
        name = key[0]
        errs = {}
        for quant in (False, True):
            c = family_case(key, quant, seed=1000 + 10 * i + quant,
                            L=ATTN_LAYERS if not quant else 2)
            got = _call(ragged_paged_attention, c)
            want = _call(ragged_attention_plain, c)
            again = _call(ragged_paged_attention, c)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            kind = "int8" if quant else "bf16"
            errs[kind] = err
            if not err < TOL:
                raise AssertionError(f"ragged_paged_attention {name}/{kind}: "
                                     f"max abs err {err} >= {TOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"ragged_paged_attention {name}/{kind}:"
                                     " two calls on the same inputs differ")
            if key[5] and not quant:  # the cap moves the output
                nocap = _call(ragged_attention_plain, {**c, "softcap": 0.0})
                errs["uncapped_minus_capped"] = float(
                    (nocap - want).abs().max())
                if not errs["uncapped_minus_capped"] > 100 * TOL:
                    raise AssertionError(f"{name}: the softcap does not "
                                         "move the output")
            if not quant:
                timed = c
            worst = max(worst, err)
        c = timed
        nbytes, flops = attention_work(c)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        sets = _layers(c)
        before = ragged_paged_attention.launches
        ms = _time_graph(_cycled(
            lambda c: _call(ragged_paged_attention, c), sets), 48)
        eager_ms = _time_ms(_cycled(
            lambda c: _call(ragged_paged_attention, c), sets), 48)
        ragged_paged_attention.launches = before  # timing is not the path
        plain_ms = _time_ms(_cycled(
            lambda c: _call(ragged_attention_plain, c), sets), 8)
        library_ms = None
        if not key[5]:
            lib_runs = [_library_call(cl) for (cl,) in sets]
            library_ms = _time_graph(_cycled(lambda run: run(),
                                             [(r,) for r in lib_runs]), 24)
            del lib_runs
        out[name] = {
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOPS else "operations"),
            "library_ms": library_ms,
            "library": None if library_ms is not None else "no single call",
            "bytes": nbytes, "flops": flops, "max_abs_err": errs,
            "heads": key[1], "kv_heads": key[2], "head_dim": key[3],
            "window": key[4], "softcap": key[5],
            "q_lens": c["q_lens"].tolist(),
            "ctx": [p + n for p, n in zip(c["pos0"].tolist(),
                                          c["q_lens"].tolist())]}
        log("kernel_time", kernel="ragged_paged_attention", key=name,
            **out[name])
        del c, timed, sets
        torch.cuda.empty_cache()
    return worst, out


# the 8B projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
PROJ_8B = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336),
           "w_down": (14336, 4096)}
# decode rows up to a full mixed step, with the mixed-step instance's tile
# edges (17: its first row count; 127 / 128 / 129 and 1000: 128-row tiles)
# and the speculative verify's rows x n_draft (4, 16; 28 and 32: 7 and 8
# rows on 64-row tiles)
INT8_M = (1, 4, 8, 16, 17, 28, 32, 37, 127, 128, 129, 1000, 1024)
# Gemma-3-4B's projections (K, N) under ``quantization: int8`` (phase
# families serves them at M 1 and 128): wq, wk / wv, wo, w_gate / w_up,
# w_down
PROJ_G3 = {"wq": (2560, 2048), "wk": (2560, 1024), "wo": (2048, 2560),
           "w_gate": (2560, 10240), "w_down": (10240, 2560)}
G3_INT8_M = (1, 8, 17, 128, 129)
# timed (projection, M): decode and mixed-step sizes, bf16 x and out
INT8_TIMED = (("w_gate", 8), ("w_gate", 1024), ("wk", 8), ("wk", 1024),
              ("wq", 1024), ("w_down", 1024), ("w_gate", 128),
              ("w_gate", 512))
# one decoder layer's seven projections by shape: wq / wo, wk / wv,
# w_gate / w_up, w_down
LAYER_PROJ = {"wq": 2, "wk": 2, "w_gate": 2, "w_down": 1}
INT8_REL_TOL = 1e-4  # of the largest |output|: f32 out, and bf16 out
# beyond one bf16 unit of each output
L2_BYTES = 50 << 20


def _int8_operands(m: int, k: int, n: int, x_dtype, seed: int):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=dev) * 2e-3 + 1e-4
    x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
    return x, q, scale


def bf16_errors(got, want) -> tuple[float, float]:
    """(max |got - want| in units of want's bf16 spacing, max error beyond
    one such unit relative to max |want|). Both sides round an f32 sum to
    bf16; the two sums differ by their summation order, which moves an
    output that cancels to near zero by many of its own tiny units, so the
    check is one unit plus the f32 bound."""
    import torch

    w = want.float()
    d = (got.float() - w).abs()
    spacing = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(2 ** -126))) - 7)
    excess = (d - spacing).clamp_min(0).max() / w.abs().max()
    return float((d / spacing).max()), float(excess)


def int8_work(m: int, k: int, n: int, x_elem: int, out_elem: int):
    """(bytes, flops): x, q, scale read once, y written once; 2 flops per
    multiply-add."""
    return m * k * x_elem + k * n + n * 4 + m * n * out_elem, 2 * m * n * k


def _time_graph(fn, iters: int) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's per-call cost (Python, allocation, the ctypes
    call) is not in the figure."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
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
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def _cycled(fn, sets):
    """fn over operand copies in turn: together they exceed the L2
    cache, so each call reads its weight from device memory, as a decode
    step does."""
    cyc = itertools.cycle(sets)
    return lambda: fn(*next(cyc))


def phase_int8_kernels():
    """int8_matmul against its plain version at the 8B shapes and at
    Gemma-3-4B's, then times at the INT8_TIMED shapes (bf16 x and out,
    as served) and sums one layer's seven projections at M = 1024."""
    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import (
        _launch, int8_matmul, int8_matmul_plain, mma_plan, plan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"abs_f32out": 0.0, "abs_bf16out": 0.0, "rel_f32out": 0.0,
             "ulp_bf16out": 0.0, "excess_bf16out": 0.0}
    checks = [("llama31_8b", name, kn, m) for name, kn in PROJ_8B.items()
              for m in INT8_M]
    checks += [("gemma3_4b", name, kn, m) for name, kn in PROJ_G3.items()
               for m in G3_INT8_M]
    for model, name, (k, n), m in checks:
        for x_dtype in (torch.bfloat16, torch.float32):
            x, q, s = _int8_operands(m, k, n, x_dtype, seed=m + k + n)
            for out_dtype in (torch.bfloat16, torch.float32):
                got = int8_matmul(x, q, s, out_dtype)
                again = int8_matmul(x, q, s, out_dtype)
                want = int8_matmul_plain(x, q, s, out_dtype)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                top = float(want.float().abs().max())
                rec = {"kernel": "int8_matmul", "model": model,
                       "proj": name, "m": m,
                       "k": k, "n": n, "x": str(x_dtype)[6:],
                       "out": str(out_dtype)[6:], "max_abs_err": err,
                       "max_abs_want": top,
                       "bitwise_repeat": bool(torch.equal(got, again)),
                       "plan": plan(m, n, k, sms,
                                    x_dtype == torch.bfloat16)}
                out = "f32out" if out_dtype == torch.float32 \
                    else "bf16out"
                worst[f"abs_{out}"] = max(worst[f"abs_{out}"], err)
                if out_dtype == torch.float32:
                    rel = err / top
                    worst["rel_f32out"] = max(worst["rel_f32out"], rel)
                    ok = err <= INT8_REL_TOL * top
                    rec["rel_err"] = rel
                else:
                    ulps, excess = bf16_errors(got, want)
                    worst["ulp_bf16out"] = max(worst["ulp_bf16out"],
                                               ulps)
                    worst["excess_bf16out"] = max(
                        worst["excess_bf16out"], excess)
                    ok = excess <= INT8_REL_TOL
                    rec.update(bf16_ulps=ulps, rel_err_beyond_1ulp=excess)
                log("kernel_check", **rec)
                if not (ok and rec["bitwise_repeat"]):
                    raise AssertionError(f"int8_matmul disagrees: {rec}")
    timings = {}
    for name, m in INT8_TIMED:
        k, n = PROJ_8B[name]
        copies = max(1, -(-2 * L2_BYTES // (k * n)))
        sets = [_int8_operands(m, k, n, torch.bfloat16, seed=i)
                for i in range(copies)]
        nbytes, flops = int8_work(m, k, n, 2, 2)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        before = int8_matmul.launches
        ms = _time_graph(_cycled(int8_matmul, sets), 50)
        # the same calls launched one by one from Python, as the engine
        # launches them today
        eager_ms = _time_ms(_cycled(int8_matmul, sets), 50)
        int8_matmul.launches = before  # timing is not the path
        plain_ms = _time_graph(_cycled(int8_matmul_plain, sets), 10)
        lib_sets = [(x, q.T.contiguous(), s.to(x.dtype)) for x, q, s in sets]
        try:
            library_ms = _time_graph(
                _cycled(torch._weight_int8pack_mm, lib_sets),
                20 if m <= 16 else 2)
            library_error = None
        except (RuntimeError, NotImplementedError) as e:
            library_ms, library_error = None, str(e).splitlines()[0][:160]
        del lib_sets
        bf_sets = [(x, (q.float() * s).to(torch.bfloat16)) for x, q, s in sets]
        bf16_matmul_ms = _time_graph(_cycled(torch.matmul, bf_sets), 50)
        del bf_sets
        other = None
        if m > 16:  # the mixed-step instance at the row tile not picked
            opl = mma_plan({64: 128, 128: 64}[plan(m, n, k, sms)[0]],
                           m, n, k, sms)

            def run(x, q, s, opl=opl):  # the kernel, launch not counted
                return _launch(x, q, s, torch.bfloat16, *opl)

            excess = bf16_errors(run(*sets[0]), int8_matmul_plain(
                *sets[0], torch.bfloat16))[1]
            if excess > INT8_REL_TOL:
                raise AssertionError(f"{name} M{m} at plan {opl}: {excess}")
            other = {"plan": opl, "ms": _time_graph(_cycled(run, sets), 50)}
        del sets
        key = f"{name}_m{m}"
        timings[key] = {
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOPS else "operations"),
            "library_ms": library_ms, "library_error": library_error,
            "bf16_matmul_ms": bf16_matmul_ms, "bytes": nbytes,
            "flops": flops, "m": m, "k": k, "n": n,
            "plan": plan(m, n, k, sms), "other_tile": other,
            "weight_copies": copies,
        }
        log("kernel_time", kernel="int8_matmul", case=key, **timings[key])
    # one decoder layer of a 1024-row mixed step: its seven projections
    layer = {f: sum(c * timings[f"{name}_m1024"][f]
                    for name, c in LAYER_PROJ.items())
             for f in ("ms", "eager_ms", "bound_ms", "bf16_matmul_ms")}
    timings["layer_m1024"] = layer
    log("kernel_time", kernel="int8_matmul", case="layer_m1024", **layer)
    return worst, timings


# ------------------------------------------------------------------ phase 4

# Llama-3.1-8B-Instruct's published config.json geometry
GEOMETRY = {
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "num_hidden_layers": 32, "vocab_size": 128256, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": False,
}
# the speculative draft: Llama-3.2-1B-Instruct's published config.json
DRAFT_GEOMETRY = {
    "hidden_size": 2048, "intermediate_size": 8192,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "num_hidden_layers": 16, "vocab_size": 128256, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": True,
}
CONTEXT = 2048  # the model config's context_size
# the int8 model's phases graphs, engine and dispatch serve the 8B's first
# layers (a depth cut that keeps the default run in its time budget)
INT8_CUT_LAYERS = 8
CUT_LAYERS = 8  # the bf16 8B's depth in phases graphs, engine, dispatch
# and tiers (a depth cut: the run reached 1021.6-1030 s with them at 32)
SLOTS = 8  # the model config's max_batch_slots


def checkpoint_layout(layers: int, g: dict = GEOMETRY
                      ) -> list[tuple[str, tuple]]:
    """(name, HF [out, in] shape) of every tensor of the checkpoint (no
    lm_head when the geometry ties it to the embedding)."""
    D, F, V = g["hidden_size"], g["intermediate_size"], g["vocab_size"]
    q, kv = g["num_attention_heads"] * g["head_dim"], \
        g["num_key_value_heads"] * g["head_dim"]
    out = [("model.embed_tokens.weight", (V, D)), ("model.norm.weight", (D,))]
    if not g["tie_word_embeddings"]:
        out.append(("lm_head.weight", (V, D)))
    for i in range(layers):
        lp = f"model.layers.{i}."
        out += [(lp + "self_attn.q_proj.weight", (q, D)),
                (lp + "self_attn.k_proj.weight", (kv, D)),
                (lp + "self_attn.v_proj.weight", (kv, D)),
                (lp + "self_attn.o_proj.weight", (D, q)),
                (lp + "mlp.gate_proj.weight", (F, D)),
                (lp + "mlp.up_proj.weight", (F, D)),
                (lp + "mlp.down_proj.weight", (D, F)),
                (lp + "input_layernorm.weight", (D,)),
                (lp + "post_attention_layernorm.weight", (D,))]
    return out


PROJ_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                 "o_proj.weight", "gate_proj.weight", "up_proj.weight",
                 "down_proj.weight")


def artifact_bytes(layers: int) -> int:
    """Bytes of the int8 model's on-disk artifact: int8 projections with
    f32 per-output scales, everything else bf16."""
    import math

    total = 0
    for name, shape in checkpoint_layout(layers):
        if name.endswith(PROJ_SUFFIXES):
            total += math.prod(shape) + 4 * shape[0]
        else:
            total += 2 * math.prod(shape)
    return total


def choose_depth(want: int, path: Path) -> int:
    """The deepest model up to ``want`` layers whose bf16 checkpoint and
    int8 artifact fit the disk with 4 GB to spare (only depth is ever
    cut)."""
    import math
    import shutil

    def nbytes(layers):
        return (sum(2 * math.prod(s) for _, s in checkpoint_layout(layers))
                + artifact_bytes(layers))

    path.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(path).free
    layers = want
    while layers > 1 and nbytes(layers) + (4 << 30) > free:
        layers -= 1
    if nbytes(layers) + (4 << 30) > free:
        raise SystemExit(f"disk too small for even one layer ({free} B free)")
    return layers


def write_checkpoint(ckpt: Path, layers: int, seed: int,
                     g_: dict = GEOMETRY) -> tuple[bool, float]:
    """An HF checkpoint of geometry ``g_`` (Llama-3.1-8B's by default)
    with random bf16 weights made on the card from ``seed``
    (``config.json`` as the JAX bench writes it, with the published
    rope_scaling block; no tokenizer.json, so the byte tokenizer
    serves). Reused when its marker matches. Returns (written,
    seconds)."""
    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    marker = ckpt / "written.json"
    want = {"seed": seed, "layers": layers, "geometry": g_}
    if marker.is_file() and json.loads(marker.read_text()) == want:
        return False, 0.0
    t0 = time.perf_counter()
    ckpt.mkdir(parents=True, exist_ok=True)
    marker.unlink(missing_ok=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    layout = checkpoint_layout(layers, g_)
    shapes = [(n, torch.empty(s, dtype=torch.bfloat16, device="meta"))
              for n, s in layout]

    def tensors():
        for name, shape in layout:
            if len(shape) == 1:  # norm weights
                yield name, torch.ones(shape, dtype=torch.bfloat16, device=dev)
            else:
                w = torch.randn(shape, generator=g, device=dev)
                yield name, (w * shape[1] ** -0.5).to(torch.bfloat16)

    save_iter(tensors(), str(ckpt / "model.safetensors"), shapes=shapes)
    config = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": g_["hidden_size"],
        "intermediate_size": g_["intermediate_size"],
        "num_attention_heads": g_["num_attention_heads"],
        "num_key_value_heads": g_["num_key_value_heads"],
        "num_hidden_layers": layers, "vocab_size": g_["vocab_size"],
        "head_dim": g_["head_dim"], "rope_theta": g_["rope_theta"],
        "rope_scaling": g_["rope_scaling"],
        "max_position_embeddings": g_["max_position_embeddings"],
        "rms_norm_eps": g_["rms_norm_eps"], "torch_dtype": "bfloat16",
        "tie_word_embeddings": g_["tie_word_embeddings"],
        "bos_token_id": 128000, "eos_token_id": 128009,
    }
    (ckpt / "config.json").write_text(json.dumps(config, indent=1))
    marker.write_text(json.dumps(want))
    return True, time.perf_counter() - t0


def _http(port: int, body: dict, timeout: float = 600.0):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def check_reply(name: str, body: dict, status: int, ctype: str,
                text: str) -> dict:
    """The response's shape and usage, as the JAX server frames them."""
    if status != 200:
        raise AssertionError(f"{name}: HTTP {status}")
    max_tokens = body["max_tokens"]
    if body.get("stream"):
        if not ctype.startswith("text/event-stream"):
            raise AssertionError(f"{name}: content type {ctype}")
        frames = text.split("\n\n")
        if frames[-1] != "" or frames[-2] != "data: [DONE]":
            raise AssertionError(f"{name}: stream does not end in [DONE]")
        chunks = []
        for f in frames[:-2]:
            if not f.startswith("data: "):
                raise AssertionError(f"{name}: bad SSE frame {f[:80]!r}")
            chunks.append(json.loads(f[len("data: "):]))
        if any(c["object"] != "chat.completion.chunk" for c in chunks):
            raise AssertionError(f"{name}: wrong chunk object")
        if chunks[0]["choices"][0]["delta"] != {"role": "assistant",
                                                "content": ""}:
            raise AssertionError(f"{name}: first delta is not the role")
        last = chunks[-1]
        finish = last["choices"][0]["finish_reason"]
        usage = last["usage"]
        content = "".join(c["choices"][0]["delta"].get("content", "")
                          for c in chunks[1:-1])
    else:
        obj = json.loads(text)
        if obj["object"] != "chat.completion":
            raise AssertionError(f"{name}: object {obj['object']}")
        finish = obj["choices"][0]["finish_reason"]
        usage = obj["usage"]
        content = obj["choices"][0]["message"]["content"]
    n = usage["completion_tokens"]
    ok = n > 0 and ((finish == "length" and n == max_tokens)
                    or (finish == "stop" and n <= max_tokens))
    if not ok or usage["total_tokens"] != n + usage["prompt_tokens"]:
        raise AssertionError(f"{name}: finish {finish!r} with usage {usage}")
    return {"name": name, "stream": bool(body.get("stream")),
            "finish_reason": finish, "prompt_tokens": usage["prompt_tokens"],
            "completion_tokens": n, "content_chars": len(content)}


def reference_check(backend, layers: int) -> dict:
    """Greedy tokens the engine serves (paged arena, the CUDA kernel) must
    be argmax — within a tolerance for bf16 rounding — of the plain dense
    forward (``_attend``) over the same prompt and tokens."""
    import torch

    from localai_tfp_tpu_torch.engine.engine import GenRequest
    from localai_tfp_tpu_torch.models.transformer import KVCache, forward

    eng = backend.engine
    got = {}
    orig = eng._finish

    def spy(slot, reason):
        got["ids"] = list(slot.generated)
        return orig(slot, reason)

    eng._finish = spy
    try:
        prompt = backend.tokenizer.encode(
            "A reference prompt for the dense path check. " * 3, add_bos=True)
        ev = eng.generate(GenRequest(prompt_ids=prompt, max_tokens=12,
                                     ignore_eos=True))
    finally:
        eng._finish = orig
    if ev.error:
        raise AssertionError(f"reference request failed: {ev.error}")
    ref = dense_deficits(eng, prompt, got["ids"])
    if not ref["worst_logit_deficit"] <= ref["tol"]:
        raise AssertionError(
            f"served greedy tokens are not the dense reference's argmax: "
            f"{ref}")
    return ref


def dense_deficits(eng, prompt: list, ids: list, repeat_penalty: float = 0.0,
                   repeat_last_n: int = 64, masks: list | None = None,
                   cache_dtype=None, per_step: bool = False,
                   soft=None) -> dict:
    """How far each served greedy token ``ids`` falls below the argmax of
    the plain dense forward (``_attend``) over prompt + ids: the worst
    logit deficit against a tolerance of a quarter of the logits' std
    (bf16 rounding moves logits by a few hundredths; a wrong key or
    value moves them by whole units). inf when a logit is not finite. A
    request's ``repeat_penalty`` is applied to each row as the sampler
    applies it: over the tokens of its window (the last
    ``repeat_last_n`` of the prompt and the tokens generated before
    it), positive logits divided by it, negative ones multiplied. With
    ``masks`` (the [V] bool sampling mask of each generated token, as
    the engine built it), the argmax is over each step's admitted
    tokens; the tolerance stays that of the unmasked logits. The
    forward's cache is bf16 unless ``cache_dtype`` says otherwise;
    ``per_step`` adds each step's deficit (``deficits``); ``soft`` (rows,
    batch rows, positions) overrides the embeddings at those positions,
    as the engine does for an image prompt."""
    import torch

    from localai_tfp_tpu_torch.models.transformer import KVCache, forward

    seq = prompt + ids[:-1]
    dev = eng.device
    cache = KVCache.create(eng.spec, 1, len(seq),
                           cache_dtype or torch.bfloat16, device=dev)
    with torch.inference_mode():
        logits, _ = forward(eng.spec, eng.params,
                            torch.tensor([seq], device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            cache, soft=soft)
    rows = logits[0, len(prompt) - 1:].float()  # one row per generated token
    if repeat_penalty not in (0.0, 1.0):
        n = min(repeat_last_n if repeat_last_n > 0 else 64,
                eng.sampling.window)
        seen = torch.zeros_like(rows, dtype=torch.bool)
        for j in range(len(ids)):
            seen[j, (prompt + ids[:j])[-n:]] = True
        rows = torch.where(seen, torch.where(rows > 0, rows / repeat_penalty,
                                             rows * repeat_penalty), rows)
    finite = bool(torch.isfinite(rows).all())
    tol = 0.25 * float(rows.std())
    if masks is not None:
        import numpy as np

        keep = torch.from_numpy(np.stack(masks)).to(dev)
        rows = rows.masked_fill(~keep, float("-inf"))
    tok = torch.tensor(ids, device=dev)
    deficit = rows.max(-1).values - rows.gather(-1, tok[:, None])[:, 0]
    # a step whose mask admits nothing (-inf - -inf) is no argmax either
    deficit = deficit.nan_to_num(nan=float("inf"))
    return {"tokens": len(ids), "exact_argmax": int(
                (rows.argmax(-1) == tok).sum()),
            "worst_logit_deficit": float(deficit.max()) if finite
            else float("inf"),
            "tol": tol,
            **({"deficits": deficit.tolist() if finite
                else [float("inf")] * len(ids)} if per_step else {})}


# a mixture of experts routes each token to its top-k experts, a step
# function of the router logits: where the k-th and (k+1)-th logits of a
# position are closer than bf16 noise between two forwards (the served
# one in chunks through B1, the dense reference whole) can move them,
# the two forwards may route that position to other experts. Where the
# k-th expert carries a real share of the gate, that moves the position's
# logits by whole units, so such a step is not held to the dense argmax.
MOE_FLIP_GAP = 0.02  # router logits, of std ~1 for these weights
MOE_FLIP_WEIGHT = 0.1  # the k-th expert's gate weight


def moe_deficits(eng, prompt: list, ids: list) -> dict:
    """``dense_deficits`` for a mixture of experts, with the dense
    forward's routing recorded per position and layer: a step whose
    position some layer routes within ``MOE_FLIP_GAP`` of a tie, on an
    expert of gate weight at least ``MOE_FLIP_WEIGHT``, is excused from
    the tolerance; every other step is held to it. Reports the excused
    steps and the worst deficit over all."""
    import torch

    from localai_tfp_tpu_torch.models import transformer as tt

    spec = eng.spec
    K, E = spec.experts_per_token, spec.n_experts
    flips: list = []
    orig = tt._moe_mlp

    def recording(spec_, lp, x, dense_only=False):
        if not dense_only and K < E:
            logits = tt._router_logits(x.reshape(-1, x.shape[-1]),
                                       lp["router"])
            vals, _ = torch.topk(logits, K + 1, dim=-1)
            gap = vals[:, K - 1] - vals[:, K]
            weight = (torch.softmax(vals[:, :K], -1)[:, K - 1]
                      if spec_.moe_norm_topk
                      else torch.softmax(logits, -1).topk(K).values[:, -1])
            flips.append((gap < MOE_FLIP_GAP) & (weight >= MOE_FLIP_WEIGHT))
        return orig(spec_, lp, x, dense_only)

    tt._moe_mlp = recording
    try:
        ref = dense_deficits(eng, prompt, ids, per_step=True)
    finally:
        tt._moe_mlp = orig
    flippable = (torch.stack(flips).any(0).tolist() if flips
                 else [False] * (len(prompt) + len(ids)))
    first = len(prompt) - 1  # the position whose logits give ids[0]
    excused = [j for j, d in enumerate(ref["deficits"])
               if d > ref["tol"] and flippable[first + j]]
    kept = [d for j, d in enumerate(ref.pop("deficits")) if j not in excused]
    ref.update(worst_logit_deficit_all=ref["worst_logit_deficit"],
               worst_logit_deficit=max(kept) if kept else 0.0,
               excused_route_flips=excused,
               flippable_steps=sum(flippable[first:first + len(ids)]))
    return ref


def param_bytes(params: dict) -> int:
    from localai_tfp_tpu_torch.models.quant import leaves

    return sum(t.numel() * t.element_size() for v in params.values()
               for t in leaves(v))


def burst_bodies() -> tuple[list, list]:
    """The main burst's four requests, as (name, body): the two sent
    first and the two sent a second later."""
    long_text = ("The paged arena holds every slot's keys and values. "
                 * 30)
    first = [
        ("short_stream", {"stream": True, "max_tokens": 48,
                          "messages": [{"role": "user",
                                        "content": "Say hello."}]}),
        ("medium", {"max_tokens": 32, "messages": [
            {"role": "system", "content": "You answer briefly."},
            {"role": "user", "content": "Describe ragged attention. "
             * 12}]}),
    ]
    later = [
        ("long_stream", {"stream": True, "max_tokens": 24,
                         "messages": [{"role": "user",
                                       "content": long_text}]}),
        ("sampled", {"max_tokens": 16, "temperature": 0.8, "seed": 7,
                     "top_k": 40, "top_p": 0.9, "messages": [
                         {"role": "user", "content": "Pick a word."}]}),
    ]
    return first, later


def run_burst(port: int, model: str, eng) -> dict:
    """Four concurrent requests (two first, two a second later, so both
    arrive while others decode); every kernel count is set to 0 just
    before and read just after."""
    import threading

    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    first, later = burst_bodies()
    results: dict = {}
    errors: list = []

    def send(name, body):
        body = {"model": model, **body}
        try:
            results[name] = check_reply(name, body, *_http(port, body))
        except Exception as e:  # re-raised below
            errors.append(f"{name}: {e!r}")

    # host-clock seconds inside the engine's step functions (each ends in
    # a host read of the sampled tokens, so device time is included)
    spent = {"_decode_step": 0.0, "_mixed_step": 0.0}

    def clocked(name):
        fn = getattr(eng, name)

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return run

    for name in spent:
        setattr(eng, name, clocked(name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.metrics.forward_steps
    mixed0, decode0 = eng.metrics.mixed_steps, eng.metrics.decode_steps
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=a) for a in first]
    for t in threads:
        t.start()
    time.sleep(1.0)  # the first two are decoding when the rest arrive
    threads += [threading.Thread(target=send, args=a) for a in later]
    for t in threads[len(first):]:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "int8_matmul": int8_matmul.launches}
    for name in spent:
        delattr(eng, name)  # the class's methods again
    if errors or len(results) != len(first) + len(later):
        raise AssertionError(f"main path requests failed: {errors}")
    decode = eng.metrics.decode_steps - decode0
    return {
        "requests": list(results.values()), "wall_s": round(wall, 3),
        "completion_tokens": sum(r["completion_tokens"]
                                 for r in results.values()),
        "forward_steps": eng.metrics.forward_steps - steps0,
        "mixed_forwards": eng.metrics.mixed_steps - mixed0,
        "decode_forwards": decode,
        "decode_ms_per_forward": round(
            spent["_decode_step"] * 1e3 / max(1, decode), 3),
        "mixed_steps_s": round(spent["_mixed_step"], 3),
        "launches": launches,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
    }


def profile_decode(eng) -> dict:
    """Where a decode forward's time goes: 8 concurrent requests (all 8
    slots decoding after one mixed step) under torch.profiler; device
    busy time is the sum of the CUDA kernels' own times (graph replays'
    kernels included), its share of the window's host-clock wall the
    device's busy share, host time the host clock around the engine's
    decode steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from localai_tfp_tpu_torch.engine.engine import GenRequest

    spent = [0.0]
    fn = eng._decode_step

    def clocked(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t

    reqs = [GenRequest(prompt_ids=list(range(1 + i, 101 + i)),
                       max_tokens=24, ignore_eos=True) for i in range(8)]
    eng._decode_step = clocked
    decode0 = eng.metrics.decode_steps
    replays0 = eng.metrics.graph_replays
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in eng.submit_many(reqs):
                ev = q.get(timeout=600)
                while not ev.done:
                    ev = q.get(timeout=600)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del eng._decode_step  # the class's method again
    decode = eng.metrics.decode_steps - decode0
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # B2's kernels by name (its instances and the split-K second pass)
    b2 = {k[:80]: v for k, v in kernels.items() if "i8mm" in k}
    return {"decode_forwards": decode,
            "graph_replays": eng.metrics.graph_replays - replays0,
            "host_ms_per_decode_forward": spent[0] * 1e3 / max(1, decode),
            "device_busy_ms_total": busy, "window_ms": window_ms,
            "device_busy_share": busy / window_ms,
            "top_kernels_ms": {k[:80]: v for k, v in top},
            "int8_matmul_ms": b2, "int8_matmul_ms_total": sum(b2.values())}


# ------------------------------------------------------------ phase 7

SHARED_PREFIX = 1100  # tokens: 4 full 256-token pages and a 76-token tail
NEAR_TIE = 1e-3  # top-2 logit gap below which greedy ids may differ
# largest first-step logit difference (max over the vocabulary) allowed
# between a request served in two waves: on the H100 a row's bf16 logits
# move by up to 0.0925 with the rows it is batched with, and a planted
# sharing fault moved them by 0.333 or more (PERF.md, PR 7)
FIRST_STEP_LIMIT = 0.2
# sharing faults planted on one engine instance to show that the on/off
# comparison fails them: the tail page left as the pool handed it, or
# filled from the donor's first page instead of its tail page
FAULTS = ("skip_tail_copy", "wrong_tail_page")
YES_NO = 'root ::= "yes" | "no"'
PERSON = {"type": "object", "properties": {"name": {"type": "string"},
                                           "age": {"type": "integer"}},
          "required": ["name", "age"]}
TOOL = {"name": "set_unit", "description": "Set the temperature unit.",
        "parameters": {"type": "object",
                       "properties": {"unit": {"enum": ["c", "f"]}},
                       "required": ["unit"]}}


def _post(port: int, body: dict, headers: dict | None = None,
          timeout: float = 600.0) -> tuple[int, str]:
    """(status, body text) of a chat request; error statuses returned."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prefix_prompts(seed: int) -> tuple[str, list[str]]:
    """A system prompt whose chat-templated prefix (BOS, "system: ", the
    text, "\nuser: ") is SHARED_PREFIX byte tokens, and six user messages
    of 20-60 tokens that differ from their first character."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ("page", "arena", "kernel", "prefix", "share", "tile", "token",
             "slot", "decode", "ring", "warp", "card", "queue", "grammar")
    text = ""
    while len(text) < SHARED_PREFIX - 16:
        text += str(rng.choice(words)) + " "
    system = text[:SHARED_PREFIX - 16]
    users = []
    for i, lead in enumerate("ABCDEF"):
        n = int(rng.integers(20, 61))
        u = f"{lead}{i} "
        while len(u) < n:
            u += str(rng.choice(words)) + " "
        users.append(u[:n])
    return system, users


class EngineSpy:
    """On one engine: each request's generated ids and text at finish (by
    prompt), the per-step top-2 logit gap of every sampled row (``gaps``:
    kept on the card and read after the run) and each request's first
    step's logits, from the eager paths (``_sample``) and from the
    variants' logits after each launch; and the host seconds of decode
    steps, split by whether a row samples under a mask (with the mask's
    build and copy)."""

    def __init__(self, eng, gaps: bool = False):
        import torch

        self.eng = eng
        self.done = {}
        self.gap_rows = []
        self.first_logits = {}  # request id -> its first step's logits
        self.decode = {"masked": [0, 0.0, 0.0], "plain": [0, 0.0, 0]}
        fin, sample = eng._finish, eng._sample
        step, fmask = eng._decode_step, eng._fill_mask
        launch, fill = eng._decode_launch, eng._fill
        mlaunch, mfill = eng._mixed_launch, eng._mixed_fill
        rows_of: dict = {}  # variant -> its dispatch's real rows
        mixed_of: dict = {}  # mixed variant -> (row index, slot) sampled
        mask_s = [0.0]

        def finish(slot, reason):
            if slot.request is not None:
                req = slot.request
                self.done[tuple(req.prompt_ids)] = {
                    "id": req.id, "ids": list(slot.generated),
                    "greedy": req.temperature <= 0,
                    "repeat_penalty": (req.repeat_penalty,
                                       req.repeat_last_n),
                    "text": slot.decoder.text if slot.decoder else "",
                    "request": req,
                    "reason": reason,
                    "ttft_ms": ((slot.t_first - req.t_submit) * 1e3
                                if slot.t_first else None)}
            return fin(slot, reason)

        def note(ids, logits, first):
            if gaps:
                top = torch.topk(logits.float(), 2, dim=-1).values
                self.gap_rows.append((ids, top[:, 0] - top[:, 1]))
                for i, rid in enumerate(ids):
                    if rid in first:
                        self.first_logits[rid] = logits[i].float()

        def sample_(rows, logits, m=None):
            note([s.request.id for s in rows], logits,
                 {s.request.id for s in rows if not s.generated})
            return sample(rows, logits, m)

        def fill_(v, rows, k):
            rows_of[(v.bucket, v.masked)] = [s.request.id for s in rows]
            return fill(v, rows, k)

        def launch_(v):
            # one step of a decode variant (a graph replay): its logits
            # stay in the variant until its next launch
            launch(v)
            ids = rows_of[(v.bucket, v.masked)]
            note(ids, v.logits[:len(ids)], set())

        def mfill_(v, rows, chunks, finals, samplers):
            mixed_of[(v.rows, v.T)] = [(r, s.request.id, s in finals)
                                       for r, s in enumerate(rows)
                                       if s in samplers]
            return mfill(v, rows, chunks, finals, samplers)

        def mlaunch_(v):
            mlaunch(v)
            picked = mixed_of[(v.rows, v.T)]
            if picked:
                idx = torch.tensor([r for r, _, _ in picked],
                                   device=v.logits.device)
                note([rid for _, rid, _ in picked],
                     v.logits.index_select(0, idx),
                     {rid for _, rid, fin_ in picked if fin_})

        def fmask_(rows):
            t0 = time.perf_counter()
            fmask(rows)
            mask_s[0] += time.perf_counter() - t0

        def step_(decoding):
            f0 = eng.metrics.decode_steps
            kind = "masked" if eng._masked(decoding) else "plain"
            mask_s[0] = 0.0
            t0 = time.perf_counter()
            step(decoding)
            dt = time.perf_counter() - t0
            d = self.decode[kind]
            d[0] += eng.metrics.decode_steps - f0
            d[1] += dt
            if kind == "masked":
                d[2] += mask_s[0]

        self._planted = {n: eng.__dict__[n] for n in (
            "_decode_launch", "_mixed_launch") if n in eng.__dict__}
        eng._finish, eng._sample = finish, sample_
        eng._decode_step, eng._fill_mask = step_, fmask_
        eng._decode_launch, eng._fill = launch_, fill_
        eng._mixed_launch, eng._mixed_fill = mlaunch_, mfill_

    def close(self) -> None:
        """The engine's own methods again (launches planted before the
        spy stay)."""
        for name in ("_finish", "_sample", "_decode_step", "_fill_mask",
                     "_decode_launch", "_fill",
                     "_mixed_launch", "_mixed_fill"):
            self.eng.__dict__.pop(name, None)
        for name, fn in self._planted.items():
            setattr(self.eng, name, fn)

    def gaps(self) -> dict:
        """request id -> top-2 logit gap of each sampled step, in order."""
        out: dict = {}
        for rids, g in self.gap_rows:
            for rid, v in zip(rids, g.tolist()):
                out.setdefault(rid, []).append(v)
        return out

    def step_ms(self) -> dict:
        (nm, tm, mm), (np_, tp, _) = (self.decode["masked"],
                                      self.decode["plain"])
        return {"masked_forwards": nm,
                "masked_host_ms_per_forward": tm * 1e3 / max(1, nm),
                "mask_build_copy_ms_per_forward": mm * 1e3 / max(1, nm),
                "plain_forwards": np_,
                "plain_host_ms_per_forward": tp * 1e3 / max(1, np_)}


def plant_fault(eng, kind: str) -> None:
    """Break the engine's page copies on this instance only (a planted
    fault; the engine's code is untouched)."""
    copy = eng._kv_copy

    def skip_tail_copy(src, dst):
        pass

    def wrong_tail_page(src, dst):
        for s in eng.slots:
            t = eng._pool.table(s.idx)
            if src in t:
                return copy(t[0], dst)
        raise AssertionError(f"page {src} is in no slot's table")

    eng._kv_copy = {"skip_tail_copy": skip_tail_copy,
                    "wrong_tail_page": wrong_tail_page}[kind]


def shared_kv(eng, prompts: list, n: int) -> dict:
    """After a wave with sharing on: each sharer's K/V rows (and int8
    scales) over the first ``n`` positions, read through its own page
    table, must equal bitwise those of the slot that served prompts[0]
    (its full pages are that slot's by reference, the tail page a copy)."""
    import torch

    slots = [next(s for s in eng.slots if s.cache_tokens[:len(p)] == p)
             for p in prompts]

    def rows(s):
        pages = eng._pool.table(s.idx)[:-(-n // eng.page)]
        return [t[:, pages].flatten(1, 2)[:, :n] for t in (
            eng.cache.k, eng.cache.v, eng.cache.k_scale, eng.cache.v_scale)
            if t is not None]

    want = rows(slots[0])
    equal = [all(torch.equal(a, b) for a, b in zip(rows(s), want))
             for s in slots[1:]]
    return {"positions": n, "sharers": len(equal),
            "bitwise_equal": sum(equal)}


def fresh_engine(backend, prefix_cache: bool, cache_dtype=None):
    """Swap a new engine (same model, draft, settings and weights; empty
    arenas and slots) into the worker, with prefix sharing on or off (and
    the KV pages in ``cache_dtype`` when given), its graphs captured as
    the worker captures them at load."""
    import gc

    import torch

    from localai_tfp_tpu_torch.engine.engine import LLMEngine

    old = backend.engine
    kw = dict(n_slots=old.n_slots, max_seq=old.max_seq,
              cache_dtype=(old.cache.k.dtype if cache_dtype is None
                           else cache_dtype), device=old.device,
              draft=old.draft, n_draft=old.n_draft)
    spec, params, tok = old.spec, old.params, old.tokenizer
    old_label = old._mlabel
    old.close()
    backend.engine = None
    del old
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["LOCALAI_PREFIX_CACHE"] = "on" if prefix_cache else "off"
    try:
        backend.engine = LLMEngine(spec, params, tok, model=old_label, **kw)
    finally:
        os.environ.pop("LOCALAI_PREFIX_CACHE", None)
    backend.engine.warmup()  # as the worker does at load
    return backend.engine


def prefix_wave(port: int, app, model: str, backend, prefix_cache: bool,
                seed: int, layers: int, first_alone: bool = True,
                fault: str | None = None) -> dict:
    """Six greedy requests sharing the system prompt: one alone, then five
    at once (else all six at once), on a fresh engine (with ``fault``
    planted); counts, the wave's TTFT, the pool after it (leak_check), and
    the kernels' launches in the run."""
    import threading

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    eng = fresh_engine(backend, prefix_cache)
    if fault is not None:
        plant_fault(eng, fault)
    spy = EngineSpy(eng, gaps=True)
    system, users = prefix_prompts(seed)
    bodies = [{"model": model, "max_tokens": 16, "temperature": 0.0,
               "messages": [{"role": "system", "content": system},
                            {"role": "user", "content": u}]}
              for u in users]
    usage: dict = {}
    errors: list = []

    def send(i):
        status, text = _post(port, bodies[i])
        if status != 200:
            errors.append(f"request {i}: HTTP {status} {text[:200]}")
            return
        usage[i] = json.loads(text)["usage"]

    m0 = dict(vars(eng.metrics))
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    if first_alone:
        send(0)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(1 if first_alone else 0, 6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "int8_matmul": int8_matmul.launches}
    if errors or len(usage) != 6:
        raise AssertionError(f"prefix wave failed: {errors}")
    m = {k: v - m0[k] for k, v in vars(eng.metrics).items()}
    steps = m["forward_steps"]
    on_card = eng.device.type == "cuda"  # (a CPU dry run launches none)
    if on_card and launches["ragged_paged_attention"] != layers * steps:
        raise AssertionError(
            f"prefix wave: ragged_paged_attention launched "
            f"{launches['ragged_paged_attention']} times for {steps} "
            f"forwards of {layers} layers")
    deadline = time.time() + 30
    while any(s.active for s in eng.slots) and time.time() < deadline:
        time.sleep(0.01)
    eng.leak_check()
    st = eng._pool.stats()
    prompts = [backend.tokenizer.encode(srv_prompt(app, b), add_bos=True)
               for b in bodies]
    shared = min(_common(prompts[0], p) for p in prompts[1:])
    # submit to first token on the engine's host clock
    ttft = [spy.done[tuple(p)]["ttft_ms"] for p in prompts[1:]]
    return {
        "prefix_cache": prefix_cache, "first_alone": first_alone,
        "fault": fault,
        "prompt_tokens": [len(p) for p in prompts],
        "shared_prefix_tokens": shared,
        "shared_kv": shared_kv(eng, prompts, shared) if prefix_cache
        else None,
        "prompt_tokens_processed": m["prompt_tokens_processed"],
        "prefill_tokens": m["prefill_tokens"],
        "prefix_reused_tokens": m["prefix_reused_tokens"],
        "prefix_copies": m["prefix_copies"],
        "forward_steps": steps, "launches": launches,
        "wave_ttft_ms": {"mean": sum(ttft) / len(ttft), "max": max(ttft),
                         "each": ttft},
        "first_ttft_ms": spy.done[tuple(prompts[0])]["ttft_ms"],
        "wave_wall_s": wall,
        "pool": {"free": st.free, "in_use": st.in_use, "shared": st.shared,
                 "refs": st.refs, "total": st.total, "leak_check": "ok"},
        "worker_prefix_cache": backend.engine_stats()["prefix_cache"],
        "_done": {p: spy.done[tuple(p)] for p in map(tuple, prompts)},
        "_gaps": spy.gaps(), "_first": spy.first_logits,
    }


def srv_prompt(app, body: dict) -> str:
    """The chat-templated prompt the server builds for ``body``."""
    tools = [t["function"] for t in body.get("tools") or []]
    return app.evaluator.template_messages(
        app.config_loader.get(body["model"]), body["messages"],
        functions=tools or None, use_function_template=bool(tools))


def _common(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def compare_waves(got: dict, want: dict, eng, what: str) -> dict:
    """Greedy ids and first-step logits of two waves over the same
    prompts. A divergence is a near tie where ``want``'s top-2 logit gap
    at the first divergent step is below NEAR_TIE. Any other divergence
    must leave both sequences the argmax of the plain dense forward
    within the main phase's tolerance (``dense_deficits``): the step's
    batch differs between the runs, and on the card that alone moves
    bf16 logits by a few hundredths (the engine phase measures it with
    sharing off on both sides). Every request's first-step logits must
    agree within FIRST_STEP_LIMIT, which a wrong shared or copied page
    exceeds. ``faults`` lists the requests that fail."""
    same, exempt, batch, bad, first = 0, [], [], [], []
    for prompt, g in got["_done"].items():
        w = want["_done"][prompt]
        a, b = got["_first"][g["id"]], want["_first"][w["id"]]
        first.append(float((a - b).abs().max()))
        if first[-1] > FIRST_STEP_LIMIT:
            bad.append({"prompt_tokens": len(prompt),
                        "first_step_logits_max_abs_diff": first[-1],
                        "limit": FIRST_STEP_LIMIT})
        if g["ids"] == w["ids"]:
            same += 1
            continue
        j = _common(g["ids"], w["ids"])
        gaps = want["_gaps"].get(w["id"], [])
        row = {"prompt_tokens": len(prompt), "step": j,
               "top2_gap": gaps[j] if j < len(gaps) else None}
        if row["top2_gap"] is not None and row["top2_gap"] < NEAR_TIE:
            exempt.append(row)
            log("engine_near_tie", compare=what, **row, limit=NEAR_TIE)
            continue
        row["dense"] = [dense_deficits(eng, list(prompt), ids,
                                       *w.get("repeat_penalty", (0.0, 64)))
                        for ids in (g["ids"], w["ids"])]
        ok = all(d["worst_logit_deficit"] <= d["tol"] for d in row["dense"])
        (batch if ok else bad).append(row)
    return {"compare": what, "requests": len(got["_done"]),
            "identical": same, "near_tie_exempt": exempt,
            "beyond_near_tie_both_dense_argmax": batch,
            "first_step_logits_max_abs_diff": first, "faults": bad}


def grammar_checks(port: int, app, model: str, backend,
                   served: dict | None = None) -> dict:
    """(a) a raw GBNF grammar, (b) response_format json_schema, (c) one
    tool, (d) logit_bias banning (a)'s first token; every output accepted
    by the port's matcher, in full when it stopped, as a live prefix when
    cut by max_tokens. Then the host ms of masked decode steps beside
    unmasked ones, on the same engine. ``served`` (when given) gets every
    request's prompt, ids and request (``EngineSpy.done``) by case
    name."""
    from localai_tfp_tpu_torch.grammars.gbnf import (
        GrammarMatcher, parse_gbnf,
    )
    from localai_tfp_tpu_torch.grammars.json_schema import (
        functions_grammar, schema_to_gbnf,
    )

    eng = backend.engine
    spy = EngineSpy(eng)
    msgs = lambda s: [{"role": "user", "content": s}]  # noqa: E731
    cases = {
        "a_grammar": ({"grammar": YES_NO, "max_tokens": 8,
                       "messages": msgs("Answer yes or no.")}, YES_NO),
        "b_json_schema": ({"max_tokens": 64, "response_format": {
            "type": "json_schema", "json_schema": {"schema": PERSON}},
            "messages": msgs("Describe a person as JSON.")},
            schema_to_gbnf(PERSON)),
        "c_tools": ({"max_tokens": 64,
                     "tools": [{"type": "function", "function": TOOL}],
                     "messages": msgs("Use Fahrenheit.")},
                    functions_grammar([TOOL])),
    }
    out = {}

    def run(name, body, grammar):
        body = {"model": model, "temperature": 0.0, **body}
        status, text = _post(port, body)
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status} {text[:300]}")
        choice = json.loads(text)["choices"][0]
        prompt = backend.tokenizer.encode(srv_prompt(app, body),
                                          add_bos=True)
        done = spy.done[tuple(prompt)]
        if served is not None:
            served[name] = {**done, "prompt": tuple(prompt)}
        m = GrammarMatcher(parse_gbnf(grammar))
        st = m.accept_string(m.initial_state(), done["text"])
        finish = choice["finish_reason"]
        full = finish in ("stop", "tool_calls")
        ok = m.can_end(st) if full else bool(st)
        if not ok or finish not in ("stop", "tool_calls", "length"):
            raise AssertionError(f"{name}: output {done['text']!r} "
                                 f"({finish}) is not accepted by the "
                                 "grammar matcher")
        out[name] = {"finish_reason": finish, "text": done["text"],
                     "tokens": len(done["ids"]),
                     "tool_calls": [c["function"] for c in
                                    choice["message"].get("tool_calls")
                                    or []]}
        return done

    first = run("a_grammar", *cases["a_grammar"])
    if out["a_grammar"]["finish_reason"] != "stop":
        raise AssertionError(f"(a) finished {out['a_grammar']}")
    for name in ("b_json_schema", "c_tools"):
        run(name, *cases[name])
    c = out["c_tools"]
    if c["finish_reason"] == "tool_calls" and [
            t["name"] for t in c["tool_calls"]] != ["set_unit"]:
        raise AssertionError(f"(c) tool calls {c['tool_calls']}")
    ban = {str(first["ids"][0]): -100}
    body, g = cases["a_grammar"]
    run("d_logit_bias", {**body, "logit_bias": ban}, g)
    d = out["d_logit_bias"]
    if d["finish_reason"] != "stop" or {d["text"], first["text"]} != {
            "yes", "no"}:
        raise AssertionError(f"(d) {d} after (a) {out['a_grammar']}")
    # masked against unmasked decode steps, one request each
    for name, body in (("story", {"max_tokens": 32, "ignore_eos": True,
                                  "messages": msgs("Tell a story.")}),
                       ("json_object", {"max_tokens": 32, "response_format": {
                           "type": "json_object"},
                           "messages": msgs("Tell a story as JSON.")})):
        body = {"model": model, "temperature": 0.0, **body}
        status, text = _post(port, body)
        if status != 200:
            raise AssertionError(f"step timing: HTTP {status} {text[:200]}")
        if served is not None:
            prompt = tuple(backend.tokenizer.encode(srv_prompt(app, body),
                                                    add_bos=True))
            served[name] = {**spy.done[prompt], "prompt": prompt}
    out["decode_steps"] = spy.step_ms()
    spy.close()
    return out


def deadline_checks(port: int, model: str) -> dict:
    """A timeout of 1e-6 s is a 504 while queued; an X-Request-Timeout that
    expires mid-decode returns partial text with deadline_exceeded."""
    body = {"model": model, "max_tokens": 8,
            "messages": [{"role": "user", "content": "Too late."}]}
    status, text = _post(port, {**body, "timeout": 1e-6})
    if status != 504:
        raise AssertionError(f"timeout 1e-6: HTTP {status} {text[:200]}")
    # a grammar of letters, so every token is text (a random model's
    # free choice is mostly ids past the byte tokenizer's, which decode
    # to nothing, and a deadline with no text is the 504 above)
    long = {"model": model, "max_tokens": 1024, "ignore_eos": True,
            "temperature": 0.0, "grammar": "root ::= [a-z]+",
            "messages": [{"role": "user", "content": "Count slowly."}]}
    t0 = time.perf_counter()
    status, text = _post(port, long, {"X-Request-Timeout": "1.5"})
    wall = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"mid-decode deadline: HTTP {status} "
                             f"{text[:200]}")
    obj = json.loads(text)
    finish = obj["choices"][0]["finish_reason"]
    content = obj["choices"][0]["message"]["content"]
    n = obj["usage"]["completion_tokens"]
    if finish != "deadline_exceeded" or not content or n >= 1024:
        raise AssertionError(f"mid-decode deadline: {finish} after {n} "
                             "tokens")
    return {"queued_1e-6_status": 504, "mid_decode_finish": finish,
            "mid_decode_tokens": n, "mid_decode_wall_s": wall,
            "timeout_s": 1.5}


def phase_engine(port: int, app, model: str, backend, layers: int,
                 seed: int) -> dict:
    """Prefix sharing (on against off), grammars and deadlines over HTTP
    on the served 8B-geometry model."""
    on = prefix_wave(port, app, model, backend, True, seed, layers)
    off = prefix_wave(port, app, model, backend, False, seed, layers)
    # sharing off and all six at once: no prompt token is reused, only
    # the batches differ from the off wave's; how far batch composition
    # alone moves greedy ids and logits on the card
    six = prefix_wave(port, app, model, backend, False, seed, layers,
                      first_alone=False)
    cmp = compare_waves(on, off, backend.engine, "sharing on vs off")
    noise = compare_waves(six, off, backend.engine,
                          "off, six at once vs one then five")
    for c in (cmp, noise):
        if c["faults"]:
            raise AssertionError(
                f"{c['compare']}: ids off the dense reference beyond near "
                f"ties, or first-step logits apart: {c['faults']}")
    kv = on["shared_kv"]
    if kv["bitwise_equal"] != kv["sharers"]:
        raise AssertionError(f"shared prefix K/V differs from its donor's: "
                             f"{kv}")
    # the same checks must fail a wave with a sharing fault planted
    planted = {}
    for kind in FAULTS:
        w = prefix_wave(port, app, model, backend, True, seed, layers,
                        fault=kind)
        planted[kind] = {"shared_kv": w["shared_kv"], **compare_waves(
            w, off, backend.engine, f"planted {kind} vs off")}
        log("engine_planted_fault", model=model, **planted[kind])
    # each check on its own must catch each fault
    missed = [k for k, p in planted.items() if not p["faults"] or
              p["shared_kv"]["bitwise_equal"] == p["shared_kv"]["sharers"]]
    if missed:
        raise AssertionError(f"planted sharing faults passed a check: "
                             f"{missed}")
    if not on["prefill_tokens"] < off["prefill_tokens"]:
        raise AssertionError(f"sharing computed {on['prefill_tokens']} "
                             f"prompt tokens, not fewer than "
                             f"{off['prefill_tokens']}")
    if on["shared_prefix_tokens"] != SHARED_PREFIX:
        raise AssertionError(f"shared prefix {on['shared_prefix_tokens']}")
    for w in (on, off, six):
        log("engine_prefix", model=model,
            **{k: v for k, v in w.items() if not k.startswith("_")})
    log("engine_prefix_compare", model=model, **cmp)
    log("engine_prefix_compare", model=model, **noise)
    fresh_engine(backend, True)  # sharing on, as served
    gram = grammar_checks(port, app, model, backend)
    log("engine_grammar", model=model, **gram)
    dl = deadline_checks(port, model)
    log("engine_deadline", model=model, **dl)
    backend.engine.leak_check()
    pc = prompt_cache_leg(app, model, backend, seed)
    log("engine_prompt_cache", model=model, **pc)
    return {"on": {k: v for k, v in on.items() if not k.startswith("_")},
            "off": {k: v for k, v in off.items() if not k.startswith("_")},
            "compare": cmp, "batch_noise": noise, "planted": planted,
            "grammar": gram,
            "deadline": dl, "prompt_cache": pc}


def prompt_cache_leg(app, model: str, backend, seed: int) -> dict:
    """The on-disk prompt cache through the worker (``PredictOptions``'
    ``prompt_cache_path``): the prefix waves' first prompt (~1140 tokens)
    served on a fresh engine, which saves its prompt's K/V rows; then a
    fresh engine on the same weights (its graphs captured: the live
    arena) restores them in place and serves the prompt again. Records
    the file's bytes, the save wall (the request's end to the file in
    place) and the restore's (inside the engine), TTFT restored against
    cold, prompt tokens computed, the restore outcomes, and the ids
    (equal, or held to the dense reference as the prefix waves are).
    The file (~300 MB at 8B: f32 rows) is removed afterwards."""
    from localai_tfp_tpu_torch.telemetry import metrics as tm
    from localai_tfp_tpu_torch.workers.base import PredictOptions

    system, users = prefix_prompts(seed)
    body = {"model": model, "max_tokens": 16, "temperature": 0.0,
            "messages": [{"role": "system", "content": system},
                         {"role": "user", "content": users[0]}]}
    prompt = srv_prompt(app, body)
    cache_dir = ROOT / "build" / "chip_smoke" / "prompt_cache"
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"{model}.npz"
    path.unlink(missing_ok=True)
    results = ("restored", "stale", "no_file", "error", "shape_mismatch",
               "dtype_mismatch", "skipped_draft")
    runs = {}
    try:
        for run in ("cold", "restored"):
            eng = fresh_engine(backend, True)
            spy = EngineSpy(eng, gaps=True)
            load_s = [0.0]
            load = eng._try_load_prompt_cache

            def timed(slot, req, load=load):
                t0 = time.perf_counter()
                try:
                    return load(slot, req)
                finally:
                    load_s[0] += time.perf_counter() - t0

            eng._try_load_prompt_cache = timed
            counts = [tm.ENGINE_PROMPT_CACHE_RESTORES.labels(
                model=eng._mlabel, result=r).value for r in results]
            m0 = dict(vars(eng.metrics))
            arena = (eng.cache.k.data_ptr(), eng.cache.v.data_ptr())
            try:
                rep = backend.predict(PredictOptions(
                    prompt=prompt, tokens=body["max_tokens"],
                    ignore_eos=True, prompt_cache_path=str(path)))
                t_end = time.perf_counter()
                if rep.finish_reason != "length":
                    raise AssertionError(f"prompt cache {run}: "
                                         f"{rep.finish_reason} {rep.error}")
                if run == "cold":
                    while not path.exists():
                        if time.perf_counter() - t_end > 120:
                            raise AssertionError("prompt cache never "
                                                 "written")
                        time.sleep(0.005)
                    save_s = time.perf_counter() - t_end
            finally:
                spy.close()
                eng.__dict__.pop("_try_load_prompt_cache", None)
            m = {k: v - m0[k] for k, v in vars(eng.metrics).items()}
            runs[run] = {
                "ttft_ms": rep.timing_first_token,
                "prompt_tokens": rep.prompt_tokens,
                "prefill_tokens": m["prefill_tokens"],
                "restore_wall_s": load_s[0],
                "arena_in_place": arena == (eng.cache.k.data_ptr(),
                                            eng.cache.v.data_ptr()),
                "results": {r: tm.ENGINE_PROMPT_CACHE_RESTORES.labels(
                    model=eng._mlabel, result=r).value - c
                    for r, c in zip(results, counts)
                    if tm.ENGINE_PROMPT_CACHE_RESTORES.labels(
                        model=eng._mlabel, result=r).value != c},
                "_done": spy.done, "_gaps": spy.gaps(),
                "_first": spy.first_logits}
            if run == "cold":
                runs[run]["save_wall_s"] = save_s
                runs[run]["file_bytes"] = path.stat().st_size
        cold, warm = runs["cold"], runs["restored"]
        cmp = compare_waves(warm, cold, backend.engine,
                            "prompt cache restored vs cold")
        n = cold["prompt_tokens"]
        if (cold["results"] != {"no_file": 1}
                or warm["results"] != {"restored": 1}
                or warm["prefill_tokens"] != 1
                or cold["prefill_tokens"] != n
                or not warm["arena_in_place"] or cmp["faults"]):
            raise AssertionError(f"{model}: prompt cache cold "
                                 f"{_public(cold)}, restored "
                                 f"{_public(warm)}, {cmp['faults']}")
    finally:
        path.unlink(missing_ok=True)
    return {"cold": _public(cold), "restored": _public(warm),
            "ttft_restored_over_cold": warm["ttft_ms"] / cold["ttft_ms"],
            "compare": cmp}


def burst_requests(app, model: str, backend, bodies=None) -> list:
    """The main burst's four requests (else ``bodies``) as the engine's
    GenRequests over the served chat prompts, each running to its
    max_tokens."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    if bodies is None:
        first, later = burst_bodies()
        bodies = [b for _, b in first + later]
    reqs = []
    for body in bodies:
        body = {"model": model, **body}
        reqs.append(GenRequest(
            prompt_ids=backend.tokenizer.encode(srv_prompt(app, body),
                                                add_bos=True),
            max_tokens=body["max_tokens"],
            temperature=body.get("temperature", 0.0),
            top_k=body.get("top_k", 0), top_p=body.get("top_p", 1.0),
            seed=body.get("seed"), ignore_eos=True))
    return reqs


GRAPH_MODES = ("graph", "bucket", "eager")


def eager_loop(eng):
    """Plain decode steps through the eager loop over exactly the
    decoding rows, on this engine instance only; returns it."""
    eng._decode_graph = eng._decode_eager
    return eng


def graphs_wave(app, model: str, backend, mode: str) -> dict:
    """The burst's four requests in one admission wave (one schedule,
    whatever the host's timing) on a fresh engine with its graphs
    captured: ``graph`` as served, ``bucket`` the same variant body run
    eagerly at its bucket (no replay), ``eager`` the eager loop over
    exactly the decoding rows. Ids, gaps and first-step logits
    (EngineSpy), host ms per decode forward, the engine's counters and
    the kernels' launches, set to 0 just before and read just after."""
    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    eng = fresh_engine(backend, True)
    if mode == "bucket":
        eng._decode_launch = eng._decode_body
    elif mode == "eager":
        eager_loop(eng)
    spy = EngineSpy(eng, gaps=True)
    reqs = burst_requests(app, model, backend)
    m0 = dict(vars(eng.metrics))
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.perf_counter()
    try:
        reasons = []
        for q in eng.submit_many(reqs):
            ev = q.get(timeout=600)
            while not ev.done:
                ev = q.get(timeout=600)
            reasons.append(ev.finish_reason)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
    finally:
        spy.close()
    if reasons != ["length"] * len(reqs):
        raise AssertionError(f"graphs wave ({mode}): {reasons}")
    m = {k: v - m0[k] for k, v in vars(eng.metrics).items()}
    return {"mode": mode, "wall_s": wall,
            "forward_steps": m["forward_steps"],
            "decode_forwards": m["decode_steps"],
            "graph_replays": m["graph_replays"],
            "eager_decode_forwards": m["decode_steps"] - m["graph_replays"],
            "host_ms_per_decode_forward":
                spy.step_ms()["plain_host_ms_per_forward"],
            "launches": launches,
            "_done": spy.done, "_gaps": spy.gaps(), "_first": spy.first_logits}


def scrape_metrics(port: int, label: str) -> dict:
    """GET /metrics: its content type and the engine families the phase
    reports (``label`` is the engine's model label)."""
    import re
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        ctype, text = r.headers.get("Content-Type", ""), r.read().decode()
    vals: dict = {}
    for line in text.splitlines():
        m = re.match(r'^([a-z_]+)\{(.*)\} (\S+)$', line)
        if not m:
            continue
        labels = dict(re.findall(r'([a-z_]+)="([^"]*)"', m.group(2)))
        if labels.pop("model", None) == label:
            vals.setdefault(m.group(1), {})[
                ",".join(f"{k}={v}" for k, v in sorted(labels.items()))] = \
                float(m.group(3))
    return {"content_type": ctype,
            "engine_mfu_ratio": vals.get("engine_mfu_ratio", {}).get(""),
            "engine_hbm_bytes": {k.split("=", 1)[1]: v for k, v in vals.get(
                "engine_hbm_bytes", {}).items()},
            "engine_device_flops_total": vals.get(
                "engine_device_flops_total", {}),
            "engine_dispatch_compile_variants_count": vals.get(
                "engine_dispatch_compile_variants_count", {}).get(""),
            "engine_warmup_seconds": vals.get("engine_warmup_seconds", {})}


def phase_graphs(port: int, app, model: str, backend) -> dict:
    """The compiled decode on the served model: the burst in one wave as
    served (graph replays), with the variant body run eagerly at the
    same bucket (greedy and seeded sampled ids and every kernel's
    launches equal), and with the eager loop over exactly the decoding
    rows (greedy ids equal or dense-held); torch.profiler windows of
    the graph and the eager loop; then the HTTP burst and a /metrics
    scrape."""
    from localai_tfp_tpu_torch.telemetry.registry import CONTENT_TYPE

    waves = {mode: graphs_wave(app, model, backend, mode)
             for mode in GRAPH_MODES}
    g, b, e = (waves[m] for m in GRAPH_MODES)
    for w in waves.values():
        log("graphs_wave", model=model, **_public(w))
    apart = [len(p) for p in g["_done"]
             if g["_done"][p]["ids"] != b["_done"][p]["ids"]]
    if apart:
        raise AssertionError(f"{model}: graph and eager at the same bucket "
                             f"differ for prompts of {apart} tokens")
    if g["launches"] != b["launches"]:
        raise AssertionError(f"{model}: launches per replay {g['launches']}"
                             f" != per call {b['launches']}")
    on_card = backend.engine.device.type == "cuda"  # (a CPU dry run
    # replays nothing)
    if not g["decode_forwards"] or (on_card and g["eager_decode_forwards"]) \
            or b["graph_replays"] or e["graph_replays"]:
        raise AssertionError(f"{model}: replays {g['graph_replays']} of "
                             f"{g['decode_forwards']} decode forwards")
    cmp = compare_waves(_greedy_only(g), _greedy_only(e), backend.engine,
                        "graph vs unpadded eager")
    log("graphs_compare", model=model, **cmp)
    if cmp["faults"]:
        raise AssertionError(f"{model}: graph against the unpadded eager "
                             f"loop: {cmp['faults']}")
    # no engine is held here across fresh_engine: each old one is
    # collected there, so the ledger below sees only the served engine
    prof_eager = profile_decode(eager_loop(fresh_engine(backend, True)))
    log("graphs_profile", model=model, mode="eager", **prof_eager)
    prof_graph = profile_decode(fresh_engine(backend, True))
    log("graphs_profile", model=model, mode="graph", **prof_graph)
    eng = fresh_engine(backend, True)
    burst = run_burst(port, model, eng)
    scrape = scrape_metrics(port, eng._mlabel)
    hbm = eng.hbm_stats()
    mfu = scrape["engine_mfu_ratio"]
    # a paging engine attributes its weights by tier (weights_hot)
    weights = "weights_hot" if eng._pager is not None else "weights"
    if scrape["content_type"] != CONTENT_TYPE or not (
            mfu is not None and 0 < mfu <= 1) or not all(
            scrape["engine_hbm_bytes"].get(c, 0) > 0 for c in (
                weights, "kv_arena", "sampler")
            + (("graph_pool",) if on_card else ())):
        raise AssertionError(f"{model}: /metrics {scrape}")
    return {
        "warmup_s": eng.metrics.warmup_s,
        "load_warmup_s": backend.load_breakdown["warmup_s"],
        "variants": eng.variant_count(),
        "graph_pool_bytes": eng._graph_pool_bytes,
        "host_ms_per_decode_forward": {
            m: waves[m]["host_ms_per_decode_forward"] for m in GRAPH_MODES},
        "launches": {m: waves[m]["launches"] for m in GRAPH_MODES},
        "graph_replays": g["graph_replays"],
        "eager_decode_forwards": g["eager_decode_forwards"],
        "ids_graph_vs_bucket": "bitwise equal (4 of 4, sampled included)",
        "compare_unpadded": cmp,
        "profile": {"graph": prof_graph, "eager": prof_eager},
        "burst": burst, "metrics": scrape,
        "ledger": {k: hbm.get(k) for k in (
            "attributed", "bytes_in_use", "bytes_allocated", "unattributed",
            "drift_ratio", "device_used")},
        "costmodel": eng.cost_stats(),
    }


# ------------------------------------------------------------ phase 9

DISPATCH_STREAMS = 4  # decoding streams the burst and the flood land beside
FLOOD = 4  # prompts of the flood, each as long as the burst's longest
HELD = 4  # queued requests of 2000 tokens (at 32 layers) whose drain a
# shed request hears
DISPATCH_MODES = ("graph", "variant", "eager")
PREDICTED = ("predicted completion exceeds deadline (prefill alone "
             "overruns it)")


class DispatchClock:
    """On one engine: host seconds of each mixed and decode step, the
    device span of each dispatch by kind (the engine's CUDA-event spans)
    and of each mixed step by its variant's padded shape (the eager path
    keys its step so too), each decode step's k, when each request's
    tokens were delivered (the end of each step that emitted any), and
    int8_matmul's launches by M (``_b2_by_m``)."""

    def __init__(self, eng):
        self.eng = eng
        self.host = {"mixed": [], "decode": []}
        self.span = {"mixed": [], "decodek": []}
        self.ks: list = []
        self.shapes: dict = {}  # mixed variant (rows, T) -> its steps
        self.span_by_shape: dict = {}  # (rows, T) -> mixed steps' spans
        self.delivered: dict = {}  # request id -> [perf_counter, ...]
        self.by_m, self._undo = _b2_by_m(eng)
        mixed, decode = eng._mixed_step, eng._decode_step
        harvest, emit = eng._harvest, eng._emit_token
        variant = eng._mixed_variant
        cur: list = []

        def variant_(R, T):
            self.shapes[(R, T)] = self.shapes.get((R, T), 0) + 1
            return variant(R, T)

        def clocked(fn, kind):
            def run(*a):
                cur.clear()
                f0 = eng.metrics.decode_steps
                t0 = time.perf_counter()
                fn(*a)
                t1 = time.perf_counter()
                self.host[kind].append(t1 - t0)
                if kind == "decode" and eng.metrics.decode_steps > f0:
                    self.ks.append(eng.metrics.decode_steps - f0)
                for rid in set(cur):
                    self.delivered.setdefault(rid, []).append(t1)
            return run

        def harvest_(kind, key, pred, *timeline):
            span = harvest(kind, key, pred, *timeline)
            self.span.setdefault(kind, []).append(span)
            if kind == "mixed":
                self.span_by_shape.setdefault(key[1], []).append(span)
            return span

        def emit_(slot, tok, defer=False):
            cur.append(slot.request.id)
            return emit(slot, tok, defer)

        eng._mixed_step = clocked(mixed, "mixed")
        eng._decode_step = clocked(decode, "decode")
        eng._harvest, eng._emit_token = harvest_, emit_
        eng._mixed_variant = variant_

    def close(self) -> None:
        self._undo()
        for name in ("_mixed_step", "_decode_step", "_harvest",
                     "_emit_token", "_mixed_variant"):
            self.eng.__dict__.pop(name, None)

    def ms(self, what: str, kind: str) -> float | None:
        xs = (self.host if what == "host" else self.span)[kind]
        return sum(xs) * 1e3 / len(xs) if xs else None

    def gaps_ms(self, ids: list, t0: float, t1: float) -> list:
        """Delivery gaps (ms) of requests ``ids`` that end in [t0, t1]."""
        out = []
        for rid in ids:
            ts = self.delivered.get(rid, [])
            out += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])
                    if t0 <= b <= t1]
        return out


def _pct(xs: list, q: float) -> float | None:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def stream_requests(backend, n_tokens: int) -> list:
    """DISPATCH_STREAMS greedy requests with short distinct prompts, each
    decoding ``n_tokens`` tokens."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    return [GenRequest(prompt_ids=backend.tokenizer.encode(
        f"Stream {i} keeps decoding while others arrive.", add_bos=True),
        max_tokens=n_tokens, ignore_eos=True)
        for i in range(DISPATCH_STREAMS)]


def _serve_by_hand(eng, first: list, later: list, limit: float = 600.0):
    """Serve ``first`` until each has its first token, then ``later``,
    stepping the engine by hand (one schedule, whatever the host's
    timing); returns the perf_counter at which ``later`` was submitted."""
    eng._autostart = False
    qs = eng.submit_many(first)
    t_end = time.perf_counter() + limit

    def run_until(cond):
        while not cond():
            if time.perf_counter() > t_end:
                raise AssertionError("dispatch wave did not finish")
            eng._admit()
            eng.step()

    run_until(lambda: all(s.generated for s in eng.slots if s.active)
              and not eng._pending)
    t_later = time.perf_counter()
    qs += eng.submit_many(later)
    run_until(lambda: not eng._pending and not any(
        s.active for s in eng.slots))
    reasons = []
    for q in qs:
        ev = q.get(timeout=5)
        while not ev.done:
            ev = q.get(timeout=5)
        reasons.append(ev.finish_reason)
    if reasons != ["length"] * len(qs):
        raise AssertionError(f"dispatch wave: {reasons}")
    return t_later


def ragged_requests(app, model: str, backend) -> tuple[list, list]:
    """(e) A lone prompt as long as the burst's longest (1578 tokens:
    three 512-token chunks that sample nothing, so no step reads back,
    then 42) on the idle engine; once it decodes, two 300-token prompts
    beside it: a step of 3 rows whose chunks fill 300 of the [4, 512]
    variant's 512 columns (the eager path runs [3, 300])."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    body = dict(burst_bodies()[1])["long_stream"]
    p = backend.tokenizer.encode(srv_prompt(app, {"model": model, **body}),
                                 add_bos=True)
    lone = GenRequest(prompt_ids=p, max_tokens=24, ignore_eos=True)
    two = [GenRequest(prompt_ids=p[:1] + [p[1] + i] + p[2:300], max_tokens=8,
                      ignore_eos=True) for i in (1, 2)]
    return [lone], two


def mixed_wave(app, model: str, backend, mode: str, wave=None) -> dict:
    """(a) The burst's four prompts (28-1578 tokens) admitted while
    DISPATCH_STREAMS streams decode (or ``wave()``'s (first, later)
    requests), on a fresh engine: ``graph`` as served, ``variant`` the
    same variant bodies run eagerly (no replay), ``eager`` the eager
    paths over exactly the rows. Ids and first-step logits (EngineSpy),
    host and device ms per mixed step (device ms also by variant shape),
    the padded share, the later requests' TTFT (submit to first token),
    the engine's counters and the kernels' launches, set to 0 just
    before and read just after."""
    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    eng = fresh_engine(backend, True)
    if mode == "variant":
        eng._mixed_launch = eng._mixed_body
        eng._decode_launch = eng._decode_body
    elif mode == "eager":
        eng._mixed_graph = eng._mixed_eager
        eng._decode_graph = eng._decode_eager
    spy = EngineSpy(eng, gaps=True)
    clock = DispatchClock(eng)
    first, burst = wave() if wave else (stream_requests(backend, 48),
                                        burst_requests(app, model, backend))
    m0 = dict(vars(eng.metrics))
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    try:
        t_burst = _serve_by_hand(eng, first, burst)
        torch.cuda.synchronize()
        launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
    finally:
        clock.close()
        spy.close()
    m = {k: v - m0[k] for k, v in vars(eng.metrics).items()}
    ttft = [(clock.delivered[r.id][0] - t_burst) * 1e3 for r in burst]
    on_card = eng.device.type == "cuda"  # (a CPU dry run replays none)
    if on_card and sum(clock.by_m.values()) != launches["int8_matmul"]:
        raise AssertionError(f"{model}: int8_matmul launched "
                             f"{launches['int8_matmul']} times for "
                             f"{sum(clock.by_m.values())} calls "
                             f"{clock.by_m}, {m['mixed_replays']} mixed and "
                             f"{m['graph_replays']} decode replays, "
                             f"{eng.variant_count()} variants")
    eng.leak_check()
    dec = [s * 1e3 / k for s, k in zip(clock.span["decodek"], clock.ks)]
    return {"mode": mode, "mixed_steps": m["mixed_steps"],
            "mixed_replays": m["mixed_replays"],
            "decode_forwards": m["decode_steps"],
            "graph_replays": m["graph_replays"],
            "host_ms_per_mixed_step": clock.ms("host", "mixed"),
            "device_ms_per_mixed_step": clock.ms("span", "mixed"),
            "device_ms_by_shape": {f"{r}x{t}": sum(xs) * 1e3 / len(xs)
                                   for (r, t), xs in
                                   sorted(clock.span_by_shape.items())},
            "device_ms_per_decode_forward_median": _pct(dec, 0.5),
            "padded_share": m["mixed_pad_tokens"] / max(1, m["mixed_tokens"]),
            "mixed_tokens": m["mixed_tokens"],
            "mixed_pad_tokens": m["mixed_pad_tokens"],
            "mixed_variants_stepped": {f"{r}x{t}": n for (r, t), n in
                                       sorted(clock.shapes.items())},
            "burst_ttft_ms": {"mean": sum(ttft) / len(ttft),
                              "max": max(ttft)},
            "launches": launches,
            "int8_matmul_calls_by_m": dict(sorted(clock.by_m.items())),
            "_done": spy.done, "_gaps": spy.gaps(),
            "_first": spy.first_logits}


def flood_wave(app, model: str, backend, budget_ms: float) -> dict:
    """(c) FLOOD prompts of the burst's longest (1578 tokens) admitted
    while DISPATCH_STREAMS streams decode, on a fresh engine with
    ``LOCALAI_ITL_BUDGET_MS`` = ``budget_ms`` (0: none): the streams'
    delivery gaps (host clock) while the flood prefills, the token
    buckets cost packing chose, the decode ks, the flood's TTFT."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    eng = fresh_engine(backend, True)
    _, later = burst_bodies()
    body = {"model": model, **dict(later)["long_stream"]}
    prompt = backend.tokenizer.encode(srv_prompt(app, body), add_bos=True)
    flood = [GenRequest(prompt_ids=prompt[:1] + [prompt[1] + i]
                        + prompt[2:], max_tokens=8, ignore_eos=True)
             for i in range(FLOOD)]
    streams = stream_requests(backend, 256)
    clock = DispatchClock(eng)
    os.environ["LOCALAI_ITL_BUDGET_MS"] = str(budget_ms)
    try:
        t0 = _serve_by_hand(eng, streams, flood)
    finally:
        os.environ.pop("LOCALAI_ITL_BUDGET_MS", None)
        clock.close()
    firsts = [clock.delivered[r.id][0] for r in flood]
    gaps = clock.gaps_ms([r.id for r in streams], t0, max(firsts))
    eng.leak_check()
    ks: dict = {}
    for k in clock.ks:
        ks[k] = ks.get(k, 0) + 1
    return {"itl_budget_ms": budget_ms, "prompt_tokens": len(prompt),
            "stream_gaps": len(gaps), "itl_p50_ms": _pct(gaps, 0.5),
            "itl_p99_ms": _pct(gaps, 0.99),
            "itl_max_ms": max(gaps) if gaps else None,
            "flood_ttft_ms": {"mean": sum(f - t0 for f in firsts) * 1e3
                              / len(firsts),
                              "max": (max(firsts) - t0) * 1e3},
            "mixed_steps": len(clock.host["mixed"]),
            "device_ms_per_mixed_step": clock.ms("span", "mixed"),
            "cost_buckets": dict(sorted(eng.cost_buckets.items())),
            "mixed_variants_stepped": {f"{r}x{t}": n for (r, t), n in
                                       sorted(clock.shapes.items())},
            "decode_ks": dict(sorted(ks.items()))}


def deadline_and_shed(port: int, app, model: str, backend) -> dict:
    """(d) On a fresh engine: a request whose timeout is 0.8 of its
    predicted prefill (the cost model's rows from warmup) is refused
    before any prefill (504, the reference's text, one
    ``queued_predicted`` deadline); then with the queue capped at
    HELD queued requests (the engine not yet stepping), a shed
    request's Retry-After is the predicted drain of that queue, over
    HTTP and at the engine."""
    import urllib.error
    import urllib.request

    from localai_tfp_tpu_torch.engine.engine import GenRequest
    from localai_tfp_tpu_torch.telemetry import metrics as tm

    eng = fresh_engine(backend, True)
    _, later = burst_bodies()
    body = {"model": model, **dict(later)["long_stream"], "stream": False}
    n = len(backend.tokenizer.encode(srv_prompt(app, body), add_bos=True))
    tok_ms = eng._costmodel.prefill_token_ms()
    timeout = 0.8 * tok_ms * n / 1e3
    stage = tm.ENGINE_DEADLINE_EXCEEDED.labels(model=eng._mlabel,
                                               stage="queued_predicted")
    before, filled = stage.snapshot()["value"], eng.metrics.prefill_tokens
    status, text = _post(port, {**body, "timeout": timeout})
    refused = {"prompt_tokens": n, "prefill_token_ms": tok_ms,
               "timeout_s": timeout, "status": status,
               "reference_text": PREDICTED in text,
               "queued_predicted": stage.snapshot()["value"] - before,
               "prefill_tokens": eng.metrics.prefill_tokens - filled}
    if (status, refused["reference_text"], refused["queued_predicted"],
            refused["prefill_tokens"]) != (504, True, 1.0, 0):
        raise AssertionError(f"{model}: predicted deadline {refused} "
                             f"{text[:200]}")
    eng = fresh_engine(backend, True)  # its loop starts at a submit
    eng._autostart = False
    eng.max_queue = HELD
    # the held work grows as the depth is cut, so that its predicted
    # drain stays clear of the 1 s fallback on a depth-cut model too
    held_tokens = 2000 * max(
        1, GEOMETRY["num_hidden_layers"] // backend.spec.n_layers)
    eng.submit_many([GenRequest(prompt_ids=list(range(1 + i, 29 + i)),
                                max_tokens=held_tokens, ignore_eos=True)
                     for i in range(HELD)])
    with eng._lock:
        want = eng._predicted_drain_s()
    ev = eng.submit(GenRequest(prompt_ids=[1, 2, 3], max_tokens=4)).get(
        timeout=5)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", method="POST",
        data=json.dumps({**body, "max_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            http = (r.status, r.headers.get("Retry-After"))
    except urllib.error.HTTPError as e:
        http = (e.code, e.headers.get("Retry-After"))
    shed = {"predicted_drain_s": want, "engine_retry_after_s":
            ev.retry_after_s, "engine_finish": ev.finish_reason,
            "http_status": http[0], "http_retry_after": http[1],
            "p90_fallback_s": 1.0}
    # on the card the held work drains in seconds, so the header differs
    # from the p90 fallback's (1 s with no waits yet)
    on_card = eng.device.type == "cuda"
    if (ev.finish_reason != "shed" or ev.retry_after_s != want
            or http != (429, str(max(1, round(want))))
            or (on_card and want <= 1.5)):
        raise AssertionError(f"{model}: shed Retry-After {shed}")
    return {"refused": refused, "shed": shed}


def served_masks(eng, req, ids: list) -> list | None:
    """The [V] sampling mask of each token of ``ids`` as the engine
    built it for ``req``: its grammar's admitted tokens from the state
    the tokens before it reached, and its logit_bias bans (None for a
    request with neither)."""
    from types import SimpleNamespace

    if req.constraint is None and not req.logit_bias:
        return None
    c = req.constraint
    slot = SimpleNamespace(request=req, constraint_state=(
        c.initial_state() if c is not None else None))
    out = []
    for t in ids:
        out.append(eng._constraint_mask_rows([slot])[0])
        if c is not None:
            slot.constraint_state = c.advance(slot.constraint_state, t)
    return out


def compare_masked(got: dict, want: dict, eng) -> dict:
    """Greedy requests served in two runs (by name: ``EngineSpy.done``
    with prompts): ids equal, or each run's ids the argmax of the plain
    dense forward over the tokens its sampling masks admitted
    (``served_masks``), within ``dense_deficits``' tolerance (the runs'
    step shapes differ, which moves bf16 logits by a few hundredths).
    ``faults`` lists the requests that fail."""
    same, held, bad = 0, [], []
    for name, g in got.items():
        w = want[name]
        if g["ids"] == w["ids"]:
            same += 1
            continue
        row = {"request": name, "step": _common(g["ids"], w["ids"]),
               "dense": [dense_deficits(eng, list(x["prompt"]), x["ids"],
                                        *x["repeat_penalty"],
                                        masks=served_masks(
                                            eng, x["request"], x["ids"]))
                         for x in (g, w)]}
        ok = all(d["worst_logit_deficit"] <= d["tol"] for d in row["dense"])
        (held if ok else bad).append(row)
    return {"compare": "masked graph vs eager", "requests": len(got),
            "identical": same, "held_to_masked_dense": held, "faults": bad}


def phase_dispatch(port: int, app, model: str, backend) -> dict:
    """Mixed-step and masked-decode graphs and cost-driven scheduling on
    the served model: (a) the burst beside decoding streams by replay,
    by the variant bodies eagerly (ids bitwise, launches equal) and by
    the eager paths (greedy ids equal or dense-held); (e) a lone long
    prompt, then a 3-row step of 300-token chunks, by replay and by the
    eager paths (greedy ids equal or dense-held; device ms by variant
    shape); (b) phase engine's grammar and logit_bias requests by
    replay, by the variant bodies (ids equal) and by the eager loop
    (ids equal or held to the masked dense argmax; host ms per masked
    forward);
    (c) a flood beside decoding streams with and without an ITL budget
    of twice the measured plain decode forward; (d) a predicted-deadline
    refusal and a shed request's Retry-After."""
    waves = {mode: mixed_wave(app, model, backend, mode)
             for mode in DISPATCH_MODES}
    g, v, e = (waves[m] for m in DISPATCH_MODES)
    for w in waves.values():
        log("dispatch_mixed", model=model, **_public(w))
    apart = [len(p) for p in g["_done"]
             if g["_done"][p]["ids"] != v["_done"][p]["ids"]]
    if apart:
        raise AssertionError(f"{model}: mixed graphs and their bodies run "
                             f"eagerly differ for prompts of {apart} tokens")
    if g["launches"] != v["launches"]:
        raise AssertionError(f"{model}: launches per replay {g['launches']}"
                             f" != per call {v['launches']}")
    on_card = backend.engine.device.type == "cuda"
    if on_card and (g["mixed_replays"] != g["mixed_steps"]
                    or g["graph_replays"] != g["decode_forwards"]
                    or v["mixed_replays"] or e["mixed_replays"]):
        raise AssertionError(f"{model}: replays {g['mixed_replays']} of "
                             f"{g['mixed_steps']} mixed steps, "
                             f"{g['graph_replays']} of "
                             f"{g['decode_forwards']} decode forwards")
    cmp = compare_waves(_greedy_only(g), _greedy_only(e), backend.engine,
                        "mixed graph vs eager")
    log("dispatch_mixed_compare", model=model, **cmp)
    if cmp["faults"]:
        raise AssertionError(f"{model}: mixed graphs against the eager "
                             f"paths: {cmp['faults']}")
    ragged = {mode: mixed_wave(app, model, backend, mode,
                               lambda: ragged_requests(app, model, backend))
              for mode in ("graph", "eager")}
    for w in ragged.values():
        log("dispatch_ragged", model=model, **_public(w))
    cmp_r = compare_waves(ragged["graph"], ragged["eager"], backend.engine,
                          "ragged graph vs eager")
    log("dispatch_ragged_compare", model=model, **cmp_r)
    if cmp_r["faults"] or (on_card and ragged["graph"]["mixed_replays"]
                           != ragged["graph"]["mixed_steps"]):
        raise AssertionError(f"{model}: a lone prompt's chunks and a "
                             f"3-row step by replay against the eager "
                             f"paths: {cmp_r['faults']}")
    masked, served = {}, {}
    for mode in DISPATCH_MODES:
        eng = fresh_engine(backend, True)
        if mode == "variant":
            eng._mixed_launch = eng._mixed_body
            eng._decode_launch = eng._decode_body
        elif mode == "eager":
            eng._mixed_graph = eng._mixed_eager
            eng._decode_graph = eng._decode_eager
        r0 = eng.metrics.masked_replays
        served[mode] = {}
        masked[mode] = grammar_checks(port, app, model, backend,
                                      served[mode])
        masked[mode]["masked_replays"] = eng.metrics.masked_replays - r0
        log("dispatch_masked", model=model, mode=mode, **masked[mode])
    texts = {m: {k: c["text"] for k, c in masked[m].items()
                 if isinstance(c, dict) and "text" in c}
             for m in DISPATCH_MODES}
    if [x["ids"] for x in served["graph"].values()] != [
            x["ids"] for x in served["variant"].values()]:
        raise AssertionError(f"{model}: masked graphs and their bodies run "
                             f"eagerly differ: {texts}")
    cmp_m = compare_masked(served["graph"], served["eager"], backend.engine)
    log("dispatch_masked_compare", model=model, **cmp_m)
    if cmp_m["faults"]:
        raise AssertionError(f"{model}: masked graphs against the eager "
                             f"loop: {cmp_m['faults']}")
    graph_steps = masked["graph"]["decode_steps"]
    if on_card and masked["graph"]["masked_replays"] != \
            graph_steps["masked_forwards"]:
        raise AssertionError(f"{model}: {masked['graph']['masked_replays']}"
                             f" masked replays for "
                             f"{graph_steps['masked_forwards']} forwards")
    step_ms = g["device_ms_per_decode_forward_median"]
    flood = {"off": flood_wave(app, model, backend, 0.0),
             "on": flood_wave(app, model, backend, 2.0 * step_ms)}
    for f in flood.values():
        log("dispatch_flood", model=model, **f)
    dl = deadline_and_shed(port, app, model, backend)
    log("dispatch_deadline", model=model, **dl)
    eng = fresh_engine(backend, True)  # as served
    return {
        "warmup_s": eng.metrics.warmup_s, "variants": eng.variant_count(),
        "graph_pool_bytes": eng._graph_pool_bytes,
        "mixed": {m: {k: x for k, x in waves[m].items()
                      if not k.startswith("_") and k != "mode"}
                  for m in DISPATCH_MODES},
        "compare_eager": {k: cmp[k] for k in ("requests", "identical")},
        "ragged": {m: {k: ragged[m][k] for k in (
            "mixed_steps", "device_ms_by_shape", "padded_share",
            "mixed_variants_stepped")} for m in ragged},
        "ragged_compare_eager": {k: cmp_r[k] for k in (
            "requests", "identical")},
        "masked_host_ms_per_forward": {
            m: masked[m]["decode_steps"]["masked_host_ms_per_forward"]
            for m in DISPATCH_MODES},
        "masked_outputs_equal_graph_vs_variant": True,
        "masked_compare_eager": {k: cmp_m[k] for k in (
            "requests", "identical")},
        "flood": flood, "deadline": dl,
    }


# ------------------------------------------------------------ phase tiers

TIER_SESSIONS = 8  # returning sessions, one per slot
TIER_TOKENS = 1800  # prompt tokens of each: 8 pages of 256 at 2048
TIER_HOST_MB = 4096  # host pages: 8 sessions of ~1800 tokens twice over
TIER_STREAMS_TOKENS = 96  # tokens each live stream decodes
# the phase engine's pool: twice the default (8 slots x 8 pages + 1), so
# the 8 returning sessions stage beside 8 resident ones; the default pool
# is full once every slot holds a 2048-context resident, and a stage
# needs free pages (as in the JAX tier)
TIER_KV_PAGES = 2 * SLOTS * (CONTEXT // PAGE) + 1
# per-lane transfer rate (GT/s) and encoding of each PCIe generation
PCIE_GTS = {1: (2.5, 0.8), 2: (5.0, 0.8), 3: (8.0, 128 / 130),
            4: (16.0, 128 / 130), 5: (32.0, 128 / 130)}


def _card_smi() -> str:
    """nvidia-smi's name and power limit ("cpu" without a card)."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def host_link() -> dict:
    """The card's PCIe link as nvidia-smi reads it (current and maximum
    generation and width) and the bound of one direction at the
    maximum: lanes x GT/s x the encoding's payload share / 8 (GB/s).
    Where nvidia-smi reads no link ([N/A]), the bound is the H100 SXM
    host interface's, PCIe Gen5 x16, and ``bound_source`` says so."""
    import torch

    if not torch.cuda.is_available():
        return {"gen": None, "width": None, "bound_gbs": None}
    q = ("pcie.link.gen.current,pcie.link.width.current,"
         "pcie.link.gen.max,pcie.link.width.max")
    vals = [v.strip() for v in subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0].split(",")]
    out = dict(zip(("gen_current", "width_current", "gen", "width"), vals))
    if all(v.isdigit() for v in vals):
        gen, width, src = int(vals[2]), int(vals[3]), "nvidia-smi"
    else:
        gen, width, src = 5, 16, "H100 SXM host interface (nvidia-smi: N/A)"
    gts, enc = PCIE_GTS[gen]
    return {**out, "bound_gbs": width * gts * enc / 8,
            "bound_source": f"PCIe Gen{gen} x{width}, {src}"}


def _sync(eng) -> None:
    import torch

    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _bitwise(a, b) -> bool:
    import torch

    return tuple(a.shape) == tuple(b.shape) and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def tier_prompts(n: int, tokens: int, seed: int) -> list:
    """n distinct prompts of ``tokens`` random ids (BOS first)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[1] + rng.integers(1000, 120000, tokens - 1).tolist()
            for _ in range(n)]


def tier_wave(eng, prompts: list, max_tokens: int = 8) -> dict:
    """One admission wave of greedy requests through ``submit_many``:
    each request's generated ids and TTFT (the engine's host clock,
    submit to first token), the prompt tokens the wave computed, the
    tier's hits, and B1's launches and forwards in it."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest
    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    got = {}
    fin = eng._finish

    def finish(slot, reason):
        if slot.request is not None:
            got[slot.request.id] = list(slot.generated)
        return fin(slot, reason)

    eng._finish = finish
    tier = eng._tier
    hits0 = tier.counters["prefetch_hit"] if tier is not None else 0
    filled0, steps0 = eng.metrics.prefill_tokens, eng.metrics.forward_steps
    ragged_paged_attention.launches = int8_matmul.launches = 0
    reqs = [GenRequest(prompt_ids=list(p), max_tokens=max_tokens,
                       ignore_eos=True) for p in prompts]
    try:
        finals = []
        for q in eng.submit_many(reqs):
            ev = q.get(timeout=600)
            while not ev.done:
                ev = q.get(timeout=600)
            finals.append(ev)
    finally:
        del eng._finish  # the class's method again
    bad = [f.finish_reason for f in finals if f.finish_reason != "length"]
    if bad:
        raise AssertionError(f"tier wave: {bad}")
    ttft = [f.timing_first_token_ms for f in finals]
    return {"ids": [got[r.id] for r in reqs],
            "ttft_ms": {"each": ttft, "p50": _pct(ttft, 0.5),
                        "max": max(ttft)},
            "prompt_tokens_computed": eng.metrics.prefill_tokens - filled0,
            "hits": (tier.counters["prefetch_hit"] - hits0
                     if tier is not None else 0),
            "forwards": eng.metrics.forward_steps - steps0,
            "b1_launches": ragged_paged_attention.launches,
            "b2_launches": int8_matmul.launches}


def tier_idle(eng, limit: float = 60.0) -> None:
    """Wait for the scheduler to go quiet, then land every transfer."""
    deadline = time.perf_counter() + limit
    while (eng._pending or any(s.active for s in eng.slots)) \
            and time.perf_counter() < deadline:
        time.sleep(0.005)
    eng._tier.settle()


def spill_and_check(eng, slots: list) -> dict:
    """Spill each slot's resident (urgent, as a reclaim does) at once on
    an idle engine and wait for the copies: enqueue-to-landed wall and
    GB/s; then each session's host pages against a gather of the same
    pages taken before the spill, bitwise, plane by plane."""
    import torch

    tier = eng._tier
    planes = tier._planes()
    pre = []
    for s in slots:
        npg = eng._pool.pages_for(len(s.cache_tokens))
        tbl = torch.tensor(eng._pool.table(s.idx)[:npg], dtype=torch.long,
                           device=eng.device)
        pre.append((list(s.cache_tokens),
                    {nm: a[:, tbl].clone() for nm, a in planes.items()}))
    _sync(eng)
    t0 = time.perf_counter()
    for s in slots:
        if not tier._spill(s, urgent=True, now=time.perf_counter()):
            raise AssertionError(f"slot {s.idx}: spill refused")
    nbytes = sum(sp.nbytes for sp in tier._swin.tags())
    _sync(eng)
    wall = time.perf_counter() - t0
    tier.settle()
    equal = {nm: 0 for nm in planes}
    for tokens, ref in pre:
        ent = next(e for e in tier.entries() if e.tokens == tokens)
        rows = tier.host_rows(ent)
        for nm, r in ref.items():
            want = r.reshape(r.shape[0], -1, *r.shape[3:])
            if not _bitwise(rows[nm].to(eng.device), want):
                raise AssertionError(f"spilled {nm} of a {len(tokens)}-token "
                                     "session differs from its pre-spill "
                                     "gather")
            equal[nm] += 1
    return {"sessions": len(slots), "bytes": nbytes, "ms": wall * 1e3,
            "gbs": nbytes / wall / 1e9, "bitwise_equal_sessions": equal,
            "dtype": str(planes["k"].dtype)}


def stage_timing(eng, entries: list) -> dict:
    """Promote warm entries into stage pages (side-stream H2D, then the
    scatter into the arena) a stage's worth at a time on an idle engine,
    each batch to completion; the stages are then abandoned (counted as
    ``prefetch_expired``)."""
    import uuid as _uuid
    from types import SimpleNamespace

    tier = eng._tier
    nbytes, wall = 0, 0.0
    for i in range(0, len(entries), tier.N_STAGE):
        batch = entries[i:i + tier.N_STAGE]
        reqs = [SimpleNamespace(id=_uuid.uuid4().hex,
                                prompt_ids=list(e.tokens)) for e in batch]
        _sync(eng)
        t0 = time.perf_counter()
        for r, e in zip(reqs, batch):
            if not tier._stage(r, e, e.n, time.perf_counter()):
                raise AssertionError("stage refused (pool or stage ids)")
        nbytes += sum(b for _, b, _ in tier._fwin.tags())
        _sync(eng)
        wall += time.perf_counter() - t0
        tier.settle()
        for r in reqs:
            tier._abandon_fetch(r.id, tier._fetches.pop(r.id))
    return {"sessions": len(entries), "bytes": nbytes, "ms": wall * 1e3,
            "gbs": nbytes / wall / 1e9}


def memory_by_frame(eng) -> dict:
    """The allocator's reserved bytes by owner: active blocks grouped by
    the innermost frame in the repository (recorded since the history
    was switched on; earlier blocks have none), and the reserved bytes
    no block holds (the allocator's cache), beside the HBM ledger's
    components and its unattributed remainder."""
    import torch

    if eng.device.type != "cuda":
        return {}
    def owner(blk) -> str:
        for fr in blk.get("frames") or []:
            fn = str(fr.get("filename", ""))
            if "localai_tfp_tpu_torch" in fn or fn.endswith("chip_smoke.py"):
                return (f"{fn.split('localai_tfp_tpu_torch/')[-1]}:"
                        f"{fr.get('line')} {fr.get('name')}")
        return ("(no repository frame)" if blk.get("frames")
                else "(allocated before the history)")

    snap = torch.cuda.memory._snapshot()
    pool = tuple(eng._graph_pool)
    active: dict = {}
    cached: dict = {}  # free blocks kept by the allocator, by last owner
    graph_free = 0
    segs = []  # segments holding such blocks: (size, free, live, owners)
    for seg in snap["segments"]:
        in_graphs = tuple(seg.get("segment_pool_id", ())) == pool
        free = live = 0
        owners_here: set = set()
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                where = owner(blk)
                active[where] = active.get(where, 0) + blk["size"]
                live += blk["size"]
                owners_here.add(where)
            elif in_graphs:
                graph_free += blk["size"]
            else:
                where = owner(blk)
                cached[where] = cached.get(where, 0) + blk["size"]
                free += blk["size"]
        if free:
            segs.append((seg["total_size"], free, live, sorted(owners_here)))

    def top(d: dict, n: int) -> dict:
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])

    led = eng._ledger.reconcile() if eng._ledger is not None else {}
    return {"reserved": sum(s["total_size"] for s in snap["segments"]),
            "graph_pool_free": graph_free,
            "allocator_cache": sum(cached.values()),
            "allocator_cache_by_frame": top(cached, 8),
            "allocator_cache_segments": [
                {"size": s, "free": f, "live": lv, "live_owners": o[:3]}
                for s, f, lv, o in sorted(segs, key=lambda x: -x[1])[:6]],
            "active_by_frame": top(active, 12),
            "ledger_components": led.get("components"),
            "ledger_unattributed": led.get("unattributed")}


def itl_streams(eng, backend, extra: list, arrive=None,
                tokens: int = TIER_STREAMS_TOKENS) -> dict:
    """DISPATCH_STREAMS greedy streams decoding ``tokens`` each; once
    they decode, ``extra`` requests (returning sessions) arrive beside
    them, or ``arrive()`` runs (an image chat through the HTTP route; it
    returns named perf_counter stamps). Per stream, each dispatch's
    delivery gap over the tokens it delivered: p50 and p99 over the
    streams; with ``arrive``, its stamps and the streams' first and last
    tokens in ms from their submission."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    streams = stream_requests(backend, tokens)
    times: dict = {r.id: [] for r in streams}
    emit = eng._emit_token

    def emit_(slot, tok, defer=False):
        # the dispatch a token came from: the forward count it ran to
        if slot.request is not None and slot.request.id in times:
            times[slot.request.id].append((eng.metrics.forward_steps,
                                           time.perf_counter()))
        return emit(slot, tok, defer)

    eng._emit_token = emit_
    stamps = None
    try:
        t0 = time.perf_counter()
        qs = eng.submit_many(streams)
        while not all(times[r.id] for r in streams):
            time.sleep(0.001)
        qs += eng.submit_many([GenRequest(prompt_ids=list(p), max_tokens=8,
                                          ignore_eos=True) for p in extra])
        if arrive is not None:
            stamps = arrive()
        for q in qs:
            ev = q.get(timeout=600)
            while not ev.done:
                ev = q.get(timeout=600)
    finally:
        del eng._emit_token
    gaps = []
    for ts in times.values():
        groups: dict = {}  # dispatch -> (its host time, tokens)
        for step, t in ts[1:]:  # from the first token on
            groups[step] = (groups.get(step, (t, 0))[0],
                            groups.get(step, (t, 0))[1] + 1)
        prev = ts[0][1]
        for t, k in sorted(groups.values()):
            gaps.append((t - prev) * 1e3 / k)
            prev = t
    out = {"itl_p50_ms": _pct(gaps, 0.5), "itl_p99_ms": _pct(gaps, 0.99),
           "samples": len(gaps)}
    if stamps is not None:
        out["max_ms"] = max(gaps)
        out["ms_from_submit"] = {
            "streams_first_tokens": (max(ts[0][1] for ts in times.values())
                                     - t0) * 1e3,
            "streams_last_token": (max(ts[-1][1] for ts in times.values())
                                   - t0) * 1e3,
            **{k: (v - t0) * 1e3 for k, v in stamps.items()}}
    return out


def timeline_overlap(trace: dict) -> dict:
    """From a Chrome trace of the flight recorder: the kv:* spans, the
    share of them that overlap a step:* span in time, whether any is
    blocking, and the step spans' measured against predicted ms."""
    tracks = {ev["tid"]: ev["args"]["name"] for ev in trace["traceEvents"]
              if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    kv = [ev for ev in spans if tracks.get(ev["tid"]) == "kv_tier"
          and ev["name"].startswith("kv:")]
    steps = [ev for ev in spans if tracks.get(ev["tid"]) == "device"
             and ev["name"].startswith("step:")]
    over = sum(1 for k in kv if any(
        s["ts"] < k["ts"] + k["dur"] and k["ts"] < s["ts"] + s["dur"]
        for s in steps))
    ratios = [s["args"]["measured_ms"] / s["args"]["predicted_ms"]
              for s in steps if s.get("args", {}).get("predicted_ms")]
    return {"kv_spans": len(kv), "kv_by_name": {
                n: sum(1 for k in kv if k["name"] == n)
                for n in sorted({k["name"] for k in kv})},
            "kv_overlapping_steps": over,
            "overlap_share": over / len(kv) if kv else None,
            "blocking": sum(1 for k in kv if k["args"]["blocking"]),
            "step_spans": len(steps), "priced_steps": len(ratios),
            "measured_over_predicted_p50": _pct(ratios, 0.5)}


def telemetry_routes(port: int, model: str, eng, b2: bool) -> dict:
    """The debug routes on the served engine: a streamed chat carrying a
    traceparent (echoed, and its phases in /debug/traces), a 1 s
    /debug/profile capture while a wave runs (its bytes, B1's kernel
    name in it, and B2's on the int8 model), /debug/timeline's events
    and /metrics in OpenMetrics with an exemplar."""
    import shutil
    import threading

    from localai_tfp_tpu_torch.telemetry.tracing import (
        make_traceparent,
        mint_trace_id,
        parse_traceparent,
    )

    out: dict = {}
    tid = mint_trace_id()
    status, headers, body = _req(
        port, "POST", "/v1/chat/completions",
        {"model": model, "stream": True, "max_tokens": 8,
         "messages": [{"role": "user", "content": "trace this request"}]},
        headers={"traceparent": make_traceparent(tid)})
    echoed = parse_traceparent(headers.get("traceparent", ""))
    if status != 200 or echoed is None or echoed[0] != tid:
        raise AssertionError(f"traced chat: HTTP {status}, traceparent "
                             f"{headers.get('traceparent')!r}")
    deadline = time.time() + 10
    while True:
        status, _, body = _req(port, "GET", f"/debug/traces?id={tid}")
        traces = [t for t in json.loads(body)["traces"]
                  if t["model"] == model]
        if traces and traces[0]["events"][-1]["phase"] == "stream_done":
            break
        if time.time() > deadline:
            raise AssertionError(f"/debug/traces: {body[:400]!r}")
        time.sleep(0.05)
    out["trace"] = {"phases": [e["phase"] for e in traces[0]["events"]],
                    "spans_ms": {s["name"]: s["dur_ms"]
                                 for s in traces[0]["spans"]},
                    "traceparent_echoed": True}
    want = ["receive", "auth", "queue", "admit", "prefill_dispatch",
            "first_token", "done", "stream_done"]
    if out["trace"]["phases"] != want:
        raise AssertionError(f"trace phases {out['trace']['phases']}")
    # a wave under the profiler
    os.environ["LOCALAI_PROFILER"] = "on"
    load = threading.Thread(target=tier_wave, args=(
        eng, tier_prompts(8, 100, 7), 96))
    try:
        load.start()
        time.sleep(0.2)
        status, _, body = _req(port, "GET", "/debug/profile?duration=1")
    finally:
        load.join(timeout=600)
        os.environ.pop("LOCALAI_PROFILER", None)
    if status != 200:
        raise AssertionError(f"/debug/profile: HTTP {status} {body[:300]!r}")
    prof = json.loads(body)
    text = (Path(prof["path"]) / "trace.json").read_text()
    shutil.rmtree(prof["path"], ignore_errors=True)
    names = {"b1_rpa_kernel": "rpa_kernel" in text}
    if b2:
        names["b2_i8mm"] = "i8mm" in text
    on_card = eng.device.type == "cuda"
    if on_card and not all(names.values()):
        raise AssertionError(f"profile lacks kernels: {names}")
    out["profile"] = {"bytes": prof["bytes"], "duration_s":
                      prof["duration_s"], "kernel_names": names}
    status, _, body = _req(port, "GET", "/debug/timeline")
    tl = json.loads(body)
    out["timeline"] = {"events": len(tl["traceEvents"]),
                       **{k: v for k, v in timeline_overlap(tl).items()
                          if k in ("step_spans", "priced_steps",
                                   "measured_over_predicted_p50")}}
    status, headers, body = _req(
        port, "GET", "/metrics",
        headers={"Accept": "application/openmetrics-text"})
    text = body.decode()
    ex = [ln for ln in text.splitlines() if '# {trace_id="' in ln]
    if (status != 200 or not text.endswith("# EOF\n") or not ex
            or not headers.get("Content-Type", "").startswith(
                "application/openmetrics-text")):
        raise AssertionError(f"/metrics OpenMetrics: HTTP {status}, "
                             f"{len(ex)} exemplars")
    out["openmetrics"] = {"exemplars": len(ex)}
    return out


def phase_tiers(port: int, app, model: str, backend, layers: int,
                seed: int, full: bool = True) -> dict:
    """The warm KV tier on the served model (a fresh engine: host pages
    of TIER_HOST_MB, a pool of TIER_KV_PAGES; the tier at its other
    defaults). Full (the bf16 8B at full depth): 8 sessions of 1800
    tokens: spilled on an idle engine (bytes bitwise against the
    pre-spill gather, GB/s against the host link's bound), promoted (H2D
    GB/s), evicted by 8 other sessions and served again three ways (by
    prefetch hit, resident, cold after the tier's entries are dropped:
    TTFT and prompt tokens computed; hit ids equal to resident ids; B1
    launches per forward by replay and per call), 4 decoding streams' ITL
    with and without 8 returning sessions spilling and prefetching beside
    them, the timeline's kv:* spans against step:* spans, the cold tier
    (save, load, TTFT of a cold hit against a re-prefill), the debug
    routes and the allocator's bytes by owner. Not full (the int8 model
    at INT8_CUT_LAYERS, int8 pages): 2 sessions spilled, bytes bitwise
    (k, v and their scales), one hit, the profile's kernel names."""
    import shutil
    import tempfile

    import torch

    from localai_tfp_tpu_torch.config.knobs import float_ as knobs_float
    from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT

    t_phase = time.perf_counter()
    smi = _card_smi()
    on_card = torch.cuda.is_available() and CARD == "cuda"
    if on_card:
        torch.cuda.memory._record_memory_history(max_entries=200000,
                                                 stacks="python")
    os.environ["LOCALAI_KV_TIER_HOST_MB"] = str(TIER_HOST_MB)
    os.environ["LOCALAI_KV_PAGES"] = str(TIER_KV_PAGES)
    try:
        eng = fresh_engine(backend, True, cache_dtype=(
            None if full else torch.int8))
    finally:
        os.environ.pop("LOCALAI_KV_TIER_HOST_MB", None)
        os.environ.pop("LOCALAI_KV_PAGES", None)
    tier = eng._tier
    if tier is None:
        raise AssertionError("the served engine has no KV tier")
    setting = {"kv_tier": "on", "host_mb": TIER_HOST_MB,
               "pinned": bool(tier.slab.buf.is_pinned()) if on_card
               else None, "kv_pages": eng.kv_pages, "page": eng.page,
               "idle_s": tier.idle_s, "watermark": tier.watermark}
    if on_card and not setting["pinned"]:
        raise AssertionError("the tier's host pages are not pinned")
    n = TIER_SESSIONS if full else 2
    A = tier_prompts(n, TIER_TOKENS, seed + 11)
    out: dict = {"setting": setting, "card": smi}
    first = tier_wave(eng, A)
    out["first_ttft_ms"] = first["ttft_ms"]
    if on_card:
        out["memory"] = memory_by_frame(eng)
        torch.cuda.memory._record_memory_history(enabled=None)
        log("tiers_memory", model=model, **out["memory"], card=smi)
    resident = [s for s in eng.slots if s.cache_tokens]
    out["spill"] = spill_and_check(eng, resident)
    link = host_link()
    out["spill"]["link"] = link
    if link["bound_gbs"]:
        out["spill"]["share_of_link"] = out["spill"]["gbs"] / link["bound_gbs"]
    log("tiers_spill", model=model, **out["spill"], card=smi)
    if not full:
        # the returning sessions after other sessions took the slots
        tier_wave(eng, tier_prompts(SLOTS, TIER_TOKENS, seed + 12))
        hit = tier_wave(eng, A)
        if hit["hits"] != n or hit["prompt_tokens_computed"] > n:
            raise AssertionError(f"int8 pages: {hit['hits']} hits, "
                                 f"{hit['prompt_tokens_computed']} tokens")
        out["hit"] = {k: hit[k] for k in (
            "hits", "prompt_tokens_computed", "ttft_ms", "forwards",
            "b1_launches", "b2_launches")}
        out["routes"] = telemetry_routes(port, model, eng, b2=True)
        log("tiers_int8", model=model, hit=out["hit"],
            profile=out["routes"]["profile"], card=smi)
        tier_idle(eng)
        tier.leak_check()
        eng.leak_check()
        out["phase_s"] = time.perf_counter() - t_phase
        return out
    # 8 other sessions take the slots: their captures find A covered
    B = tier_prompts(n, TIER_TOKENS, seed + 12)
    tier_wave(eng, B)
    tier_idle(eng)
    out["prefetch"] = stage_timing(eng, [e for e in tier.entries()
                                         if e.tokens[:TIER_TOKENS] in A])
    out["prefetch"]["link"] = link
    log("tiers_prefetch", model=model, **out["prefetch"], card=smi)
    FLIGHT.clear()
    hit = tier_wave(eng, A)
    res = tier_wave(eng, A)
    # the same wave per call: the variant bodies eagerly
    eng._mixed_launch, eng._decode_launch = eng._mixed_body, eng._decode_body
    try:
        res_call = tier_wave(eng, A)
    finally:
        del eng._mixed_launch, eng._decode_launch
    if hit["hits"] != n or hit["prompt_tokens_computed"] > n:
        raise AssertionError(f"returning sessions: {hit['hits']} hits, "
                             f"{hit['prompt_tokens_computed']} prompt "
                             "tokens computed")
    if hit["ids"] != res["ids"] or res_call["ids"] != res["ids"]:
        raise AssertionError("prefetch-hit ids differ from resident ids")
    for w in (hit, res, res_call):
        if on_card and w["b1_launches"] != layers * w["forwards"]:
            raise AssertionError(f"B1 {w['b1_launches']} launches for "
                                 f"{w['forwards']} forwards")
    # ITL of four streams: 8 returning sessions (B) beside them, whose
    # admissions spill the A residents (their entries dropped first) and
    # prefetch B; then the streams alone
    for e in tier.entries():
        if e.tokens[:TIER_TOKENS] in A:
            tier._drop_entry(e)
    moves0 = dict(tier.counters)
    itl_tier = itl_streams(eng, backend, B)
    tier_idle(eng)
    moved = {k: tier.counters[k] - moves0[k]
             for k in ("spills", "prefetch_hit")}
    itl_alone = itl_streams(eng, backend, [])
    tier_idle(eng)
    out["itl"] = {"with_tier_traffic": {**itl_tier, **moved},
                  "streams_alone": itl_alone}
    out["timeline"] = timeline_overlap(FLIGHT.export_chrome_trace())
    if out["timeline"]["blocking"] or not out["timeline"]["kv_spans"]:
        raise AssertionError(f"kv spans: {out['timeline']}")
    # cold: the tier's entries dropped, the sessions not resident
    tier_wave(eng, tier_prompts(n, TIER_TOKENS, seed + 13))
    tier_idle(eng)
    for e in tier.entries():
        tier._drop_entry(e)
    cold = tier_wave(eng, A)
    # (a resident may still share the BOS token with a prompt)
    if cold["hits"] or cold["prompt_tokens_computed"] < n * (
            TIER_TOKENS - 1):
        raise AssertionError(f"cold wave: {cold['hits']} hits, "
                             f"{cold['prompt_tokens_computed']} tokens")
    out["returning"] = {
        way: {"ttft_ms": w["ttft_ms"],
              "prompt_tokens_computed": w["prompt_tokens_computed"],
              "hits": w["hits"], "forwards": w["forwards"],
              "b1_launches": w["b1_launches"],
              "b2_launches": w["b2_launches"]}
        for way, w in (("prefetch_hit", hit), ("resident", res),
                       ("resident_per_call", res_call), ("cold", cold))}
    out["returning"]["hit_ids_equal_resident"] = True
    out["returning"]["cold_ids_equal_hit"] = sum(
        a == b for a, b in zip(cold["ids"], hit["ids"]))
    log("tiers_returning", model=model, **out["returning"],
        itl=out["itl"], timeline=out["timeline"], card=smi)
    # the cold tier: one session saved and loaded back
    cold_dir = Path(tempfile.mkdtemp(prefix="kv_tier_cold_",
                                     dir=ROOT / "build" / "chip_smoke"))
    try:
        tier_wave(eng, tier_prompts(n, TIER_TOKENS, seed + 14))
        tier_idle(eng)
        ent = next(e for e in tier.entries() if e.tokens[:TIER_TOKENS] == A[0])
        tier.cold_s = 0.0  # no policy saves of other entries meanwhile
        tier.cold_dir = str(cold_dir)
        t0 = time.perf_counter()
        tier._start_save(ent)
        tier_idle(eng)
        save_s = time.perf_counter() - t0
        if ent.state != "cold":
            raise AssertionError(f"cold save: entry {ent.state}")
        # the file read alone on this thread (warm: just written)
        t0 = time.perf_counter()
        from localai_tfp_tpu_torch.engine.kv_tier import read_cache_file
        with read_cache_file(ent.path) as data:
            _ = {nm: data[nm].shape for nm in data.files}
        read_s = time.perf_counter() - t0
        # the request waits for its session's load however long it takes
        # (the default deadline, 2 s, would re-prefill past it)
        tier.fetch_deadline_s = 60.0
        c0 = dict(tier.counters)
        hit1 = tier_wave(eng, A[:1])
        rep = tier_wave(eng, tier_prompts(1, TIER_TOKENS, seed + 15))
        moved = {k: tier.counters[k] - c0[k] for k in (
            "loads", "prefetch_hit", "prefetch_late", "prefetch_miss",
            "fetch_faults")}
        if moved["loads"] != 1 or hit1["hits"] != 1:
            raise AssertionError(
                f"cold tier: no load-and-hit: {moved}, entry {ent.state}, "
                f"file read alone {read_s:.3f} s, TTFT {hit1['ttft_ms']}")
        out["cold_tier"] = {
            "file_bytes": Path(ent.path).stat().st_size, "save_s": save_s,
            "file_read_alone_s": read_s,
            "fetch_deadline_s": tier.fetch_deadline_s,
            "ttft_cold_hit_ms": hit1["ttft_ms"]["max"],
            "ttft_reprefill_ms": rep["ttft_ms"]["max"],
            "prompt_tokens_computed_hit": hit1["prompt_tokens_computed"]}
    finally:
        tier.cold_dir = ""
        tier.fetch_deadline_s = max(0.05, knobs_float(
            "LOCALAI_KV_TIER_FETCH_DEADLINE_S"))
        tier.cold_s = max(0.0, knobs_float("LOCALAI_KV_TIER_COLD_S"))
        shutil.rmtree(cold_dir, ignore_errors=True)
    log("tiers_cold", model=model, **out["cold_tier"], card=smi)
    out["routes"] = telemetry_routes(port, model, eng, b2=False)
    log("tiers_routes", model=model, **out["routes"], card=smi)
    tier_idle(eng)
    tier.leak_check()
    eng.leak_check()
    out["tier_stats"] = tier.stats()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def first_layers(models: Path, ckpt_name: str, layers: int) -> str:
    """A model directory beside ``ckpt_name`` that serves its first
    ``layers`` layers: a symlink to its safetensors under a config.json of
    that depth (a depth cut that writes no weights). Its name."""
    cut = f"{ckpt_name}-first{layers}"
    (models / cut).mkdir(exist_ok=True)
    for f in (models / cut).iterdir():
        f.unlink()
    (models / cut / "model.safetensors").symlink_to(
        models / ckpt_name / "model.safetensors")
    config = json.loads((models / ckpt_name / "config.json").read_text())
    (models / cut / "config.json").write_text(json.dumps(
        {**config, "num_hidden_layers": layers}, indent=1))
    return cut


def model_yaml(models: Path, name: str, model: str, **extra) -> None:
    """The 8B phases' model config: greedy, context 2048, 8 slots, bf16."""
    (models / f"{name}.yaml").write_text(json.dumps({
        "name": name, "backend": "torch-llm",
        "parameters": {"model": model, "temperature": 0.0,
                       "max_tokens": 32},
        "context_size": CONTEXT, "max_batch_slots": SLOTS,
        "dtype": "bfloat16", **extra,
        "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                     "chat": "{{.Input}}\nassistant:"},
    }, indent=1))


def serve_model(models: Path, model: str, layers: int, quantized: bool,
                engine: bool, graphs: bool, seed: int,
                dispatch: bool = False, reload: bool = True,
                tiers: bool = False) -> dict:
    """Serve one model config through the port's HTTP server: load, the
    burst, its checks, (int8, ``reload``) a reload from the artifact, the
    dense reference check, and (``graphs``) phase 6, (``engine``) phase
    7, (``dispatch``) phase 8 and (``tiers``) phase tiers on the same
    server."""
    import threading

    import torch

    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(models), port=0, device=CARD)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = {"model": model, "max_tokens": 4,
                "messages": [{"role": "user", "content": "warm up"}]}
        check_reply("load", warm, *_http(port, warm))
        backend = srv.app.loaded()[model]
        eng = backend.engine
        load = {"mode": backend.load_mode, "load_s": round(backend.load_s, 3),
                "load_and_first_request_s": round(time.perf_counter() - t0, 3),
                "param_bytes": param_bytes(eng.params),
                "load_peak_mem_gib": round(
                    torch.cuda.max_memory_allocated() / 2**30, 3),
                "breakdown": backend.load_breakdown}
        log("main_load", model=model, **load, n_slots=eng.n_slots,
            page=eng.page, kv_pages=eng.kv_pages)
        if load["mode"] != ("quantized" if quantized else "full"):
            raise AssertionError(f"{model}: load mode {load['mode']}")
        burst = run_burst(port, model, eng)
        log("main_requests", model=model, **burst)
        # phase text's TTFT request on the byte tokenizer, alone
        byte_ttft = None if quantized else text_ttft(port, model, eng)
        steps = burst["forward_steps"]
        got = burst["launches"]
        if not burst["mixed_forwards"] or not burst["decode_forwards"]:
            raise AssertionError(f"{model}: mixed {burst['mixed_forwards']} / "
                                 f"decode {burst['decode_forwards']} "
                                 "forwards: both kinds must run")
        # attention: exactly one launch per layer of every forward
        if steps == 0 or got["ragged_paged_attention"] != layers * steps:
            raise AssertionError(
                f"{model}: ragged_paged_attention launched "
                f"{got['ragged_paged_attention']} times on the main path "
                f"for {steps} forwards of {layers} layers")
        # 7 projections per layer in every decode forward, and those of
        # mixed steps of eligible size
        need = 7 * layers * burst["decode_forwards"]
        if quantized and got["int8_matmul"] < need:
            raise AssertionError(
                f"{model}: int8_matmul launched {got['int8_matmul']} times "
                f"on the main path; it needs at least {need}")
        eng.leak_check()
        del eng  # later phases swap engines in: hold none of them here
        reloaded = None
        if quantized and reload:  # the second load reads the int8 tree
            res = backend.load_model(srv.app.model_loader.load_options(
                srv.app.config_loader.get(model)))
            if not res.success or backend.load_mode != "artifact":
                raise AssertionError(f"{model}: reload {res.message!r} in "
                                     f"mode {backend.load_mode}")
            reloaded = {"mode": backend.load_mode,
                        "load_s": round(backend.load_s, 3),
                        "param_bytes": param_bytes(backend.engine.params),
                        "breakdown": backend.load_breakdown}
            if reloaded["param_bytes"] != load["param_bytes"]:
                raise AssertionError(f"{model}: reloaded tree differs")
            log("main_reload", model=model, **reloaded)
        ref = reference_check(backend, layers)
        log("main_reference", model=model, **ref)
        prof = profile_decode(backend.engine)
        log("main_profile", model=model, **prof)
        backend.engine.leak_check()
        gr = None
        if graphs:
            gr = phase_graphs(port, srv.app, model, backend)
            log("graphs", model=model, **{k: v for k, v in gr.items()
                                          if k not in ("profile", "burst")})
        eng_res = (phase_engine(port, srv.app, model, backend, layers, seed)
                   if engine else None)
        disp = None
        if dispatch:
            disp = phase_dispatch(port, srv.app, model, backend)
            log("dispatch", model=model, **{k: v for k, v in disp.items()
                                            if k not in ("flood",
                                                         "deadline")})
        tr = None
        if tiers:
            tr = phase_tiers(port, srv.app, model, backend, layers, seed,
                             full=not quantized)
            log("tiers", model=model, phase_s=tr["phase_s"],
                setting=tr["setting"], tier_stats=tr.get("tier_stats"))
        return {"load": load, "burst": burst, "reload": reloaded,
                "reference": ref, "profile": prof, "graphs": gr,
                "engine": eng_res, "dispatch": disp, "tiers": tr,
                "byte_ttft": byte_ttft}
    finally:
        srv.close()
        th.join(timeout=30)


def phase_main(layers_wanted: int, seed: int, engine: bool,
               graphs: bool, dispatch: bool = False,
               tiers: bool = False) -> dict:
    """Serve the 8B-geometry model on the card through the port's HTTP
    server: bf16, then the same checkpoint with int8 weights."""
    import gc
    import shutil

    import torch

    models = ROOT / "build" / "chip_smoke" / "models"
    quant_cache = ROOT / "build" / "chip_smoke" / "quant"
    layers = choose_depth(layers_wanted, models)
    ckpt_name = f"llama31-8b-geometry-L{layers}-s{seed}"
    written, write_s = write_checkpoint(models / ckpt_name, layers, seed)
    model_yaml(models, "llama-3.1-8b", ckpt_name)
    model_yaml(models, "llama-3.1-8b-int8", ckpt_name, quantization="int8")
    log("main_checkpoint", layers=layers, layers_wanted=layers_wanted,
        written=written, write_s=round(write_s, 3), dir=ckpt_name)
    bf16 = serve_model(models, "llama-3.1-8b", layers, quantized=False,
                       engine=False, graphs=False, seed=seed)
    if engine or graphs or dispatch or tiers:
        # the bf16 model's phases 6-8 and tiers on the 8B's first
        # CUT_LAYERS layers (a depth cut that keeps the default run in its
        # time budget; phase main, text and lifecycle stay at full depth)
        gc.collect()
        torch.cuda.empty_cache()
        cut = first_layers(models, ckpt_name, CUT_LAYERS)
        model_yaml(models, f"llama-3.1-8b-first{CUT_LAYERS}", cut)
        bf16_cut = serve_model(
            models, f"llama-3.1-8b-first{CUT_LAYERS}", CUT_LAYERS,
            quantized=False, engine=engine, graphs=graphs, seed=seed,
            dispatch=dispatch, tiers=tiers)
        for k in ("graphs", "engine", "dispatch", "tiers"):
            bf16[k] = bf16_cut[k]
        bf16["cut"] = {"layers": CUT_LAYERS,
                       "reduced": f"phases graphs, engine, dispatch, tiers: "
                                  f"layers {CUT_LAYERS} of {layers}",
                       "burst_launches": bf16_cut["burst"]["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    # a cold int8 load: quantize on the card, then write the artifact
    shutil.rmtree(quant_cache, ignore_errors=True)
    os.environ["LOCALAI_QUANT_CACHE_DIR"] = str(quant_cache)
    os.environ["LOCALAI_QUANT_ARTIFACTS"] = "on"
    int8 = serve_model(models, "llama-3.1-8b-int8", layers, quantized=True,
                       engine=False, graphs=False, seed=seed)
    if engine or graphs or dispatch or tiers:
        # the int8 model's phases 6-8 and tiers on the same first
        # layers, quantized at load (no artifact is written)
        gc.collect()
        torch.cuda.empty_cache()
        cut = first_layers(models, ckpt_name, INT8_CUT_LAYERS)
        model_yaml(models, "llama-3.1-8b-int8-cut", cut, quantization="int8")
        os.environ["LOCALAI_QUANT_ARTIFACTS"] = "off"
        try:
            int8_cut = serve_model(
                models, "llama-3.1-8b-int8-cut", INT8_CUT_LAYERS,
                quantized=True, engine=engine, graphs=graphs, seed=seed,
                dispatch=dispatch, reload=False, tiers=tiers)
        finally:
            os.environ["LOCALAI_QUANT_ARTIFACTS"] = "on"
        for k in ("graphs", "engine", "dispatch", "tiers"):
            int8[k] = int8_cut[k]
        int8["cut"] = {"layers": INT8_CUT_LAYERS,
                       "reduced": f"phases graphs, engine, dispatch, tiers: "
                                  f"layers {INT8_CUT_LAYERS} of {layers}",
                       "burst_launches": int8_cut["burst"]["launches"]}
    log("main_models", layers=layers,
        param_gb={"bf16": bf16["load"]["param_bytes"] / 1e9,
                  "int8": int8["load"]["param_bytes"] / 1e9},
        load_s={"bf16": bf16["load"]["load_s"],
                "int8_cold": int8["load"]["load_s"],
                "int8_warm": int8["reload"]["load_s"]},
        load_breakdown={"bf16": bf16["load"]["breakdown"],
                        "int8_cold": int8["load"]["breakdown"],
                        "int8_warm": int8["reload"]["breakdown"]})
    return {"layers": layers, "checkpoint": ckpt_name, "bf16": bf16,
            "int8": int8}

# ------------------------------------------------------------ phase 8

N_DRAFT = 4
DRAFT_SEED = 1
# a rejected greedy draft token of the model drafting for itself must be
# this near the verify argmax: the two logits differ only by the batch
# dependence of bf16 rows (up to 0.0925 on the card, PERF.md §6)
REJECT_TIE = 0.2
# sampled acceptance below which the rule or the draft arena is broken
# (a model drafting for itself has p close to q)
SAMPLED_ACCEPT_MIN = 0.5
# the depth of spec's targets: the 8B checkpoint's first 4 of 32 layers
# (its tensors shared by a symlink; config.json says 4 layers), (b)'s
# draft too (a depth cut that keeps the default run in its budget
# beside phases weights and disagg)
SPEC_B_LAYERS = 4
# faults planted on (b)'s engine to show that its checks fail them: the
# prompt mirror written elsewhere (a stale draft arena; the greedy
# rejection check must fail it), or the rejection rule reading the
# target's p one position late (the sampled acceptance check must)
SPEC_FAULTS = ("stale_draft_arena", "p_one_position_late")


class SpecSpy:
    """On one engine: host seconds of speculative dispatches, the prompts
    of their rows, and (``gaps``) for each greedy verify forward the
    logit gap between the verify argmax and the rejected draft token at
    each row's first rejection (kept on the card, read after the run).
    A replay calls no Python, so ``gaps`` runs each dispatch's variant
    body eagerly (``_spec_launch = _spec_body``): the same kernels on the
    same buffers, held bitwise to the replay by ``spec_pair``."""

    def __init__(self, eng, gaps: bool = False):
        self.eng = eng
        self.dispatches, self.seconds, self.rows = 0, 0.0, set()
        self.gap_parts = []
        self._planted = {n: eng.__dict__[n] for n in ("_spec_launch",)
                         if n in eng.__dict__}
        step, verify = eng._spec_decode_step, eng._verify_logits

        def step_(decoding, mode):
            self.rows.update(tuple(s.request.prompt_ids) for s in decoding)
            t0 = time.perf_counter()
            try:
                return step(decoding, mode)
            finally:
                self.seconds += time.perf_counter() - t0
                self.dispatches += 1

        def verify_(xin, pos, pt, wt):
            lg = verify(xin, pos, pt, wt)
            m = lg[:, :-1].argmax(-1)  # [B, kd - 1] verify argmax
            d = xin[:, 1:].long()  # the drafted tokens
            miss = m != d
            i = miss.int().argmax(1, keepdim=True)  # first rejection
            row = lg[:, :-1].gather(1, i[..., None].expand(
                -1, -1, lg.shape[-1]))[:, 0]
            gap = (row.gather(1, m.gather(1, i))
                   - row.gather(1, d.gather(1, i)))[:, 0]
            self.gap_parts.append(gap[miss.any(1)])
            return lg

        eng._spec_decode_step = step_
        if gaps:
            eng._verify_logits = verify_
            eng._spec_launch = eng._spec_body

    def rejection_gaps(self) -> list:
        import torch

        return (torch.cat(self.gap_parts).tolist() if self.gap_parts
                else [])

    def close(self) -> None:
        for name in ("_spec_decode_step", "_verify_logits", "_spec_launch"):
            self.eng.__dict__.pop(name, None)
        for name, fn in self._planted.items():
            setattr(self.eng, name, fn)


def plant_spec_fault(eng, kind: str):
    """Break speculative decoding on this engine instance only (the
    engine's code is untouched); returns the undo."""
    if kind == "stale_draft_arena":
        from localai_tfp_tpu_torch.models.transformer import KVCache

        mixed = eng._mixed_step
        elsewhere = KVCache.create(eng.draft[0], eng.kv_pages, eng.page,
                                   eng.draft_cache.k.dtype,
                                   device=eng.device)

        def mixed_(prefilling, decoding):
            real, eng.draft_cache = eng.draft_cache, elsewhere
            try:
                return mixed(prefilling, decoding)
            finally:
                eng.draft_cache = real

        eng._mixed_step = mixed_
        # a mixed step's graph writes the arena it was captured over: the
        # fault takes the step's eager path, which reads eng.draft_cache
        # at each call
        eng._mixed_graph = eng._mixed_eager

        def undo_stale():
            for name in ("_mixed_step", "_mixed_graph"):
                eng.__dict__.pop(name, None)

        return undo_stale
    from localai_tfp_tpu_torch.ops import sampling

    reject = sampling.spec_reject

    def late(p_probs, p_idx, *rest):
        return reject(p_probs.roll(-1, 1), p_idx.roll(-1, 1), *rest)

    sampling.spec_reject = late
    # a captured graph runs the rule it was captured with: the fault
    # takes the variant body eagerly, which calls the module's rule
    eng._spec_launch = eng._spec_body

    def undo():
        sampling.spec_reject = reject
        eng.__dict__.pop("_spec_launch", None)

    return undo


def _b2_by_m(eng):
    """Count int8_matmul calls by their row count M as ``quant.mm`` makes
    them (on the card each call launches the kernel or raises), and for
    each replay of one of ``eng``'s graphs the calls its capture
    recorded: a decode graph's at M = its row bucket, a mixed graph's at
    M = rows x tokens of its variant, a speculative graph's at M = rows
    x n_draft (its verify forwards: the drafts here are bf16). Returns
    (counts, undo)."""
    from localai_tfp_tpu_torch.models import quant

    counts: dict = {}
    orig = quant.int8_matmul
    planted = {n: eng.__dict__[n] for n in ("_decode_launch",
                                             "_mixed_launch",
                                             "_spec_launch")
               if n in eng.__dict__}
    launch, mlaunch = eng._decode_launch, eng._mixed_launch
    slaunch = eng._spec_launch

    def counting(x, q, scale, **kw):
        counts[x.shape[0]] = counts.get(x.shape[0], 0) + 1
        return orig(x, q, scale, **kw)

    def add(v, m, replayed):
        # a launch planted to run the body eagerly makes calls, not a
        # replay: those are counted by ``counting``
        n = v.launches.get("int8_matmul", 0) if replayed else 0
        if n:
            counts[m] = counts.get(m, 0) + n

    def launch_(v):
        r0 = eng.metrics.graph_replays
        launch(v)
        add(v, v.bucket, eng.metrics.graph_replays > r0)

    def mlaunch_(v):
        r0 = eng.metrics.mixed_replays
        mlaunch(v)
        add(v, v.rows * v.T, eng.metrics.mixed_replays > r0)

    def slaunch_(v):
        r0 = eng.metrics.spec_replays
        slaunch(v)
        add(v, v.rows * eng.n_draft, eng.metrics.spec_replays > r0)

    quant.int8_matmul = counting
    eng._decode_launch, eng._mixed_launch = launch_, mlaunch_
    eng._spec_launch = slaunch_

    def undo():
        quant.int8_matmul = orig
        for name in ("_decode_launch", "_mixed_launch", "_spec_launch"):
            eng.__dict__.pop(name, None)
        for name, fn in planted.items():
            setattr(eng, name, fn)

    return counts, undo


def b2_instances(by_m: dict) -> dict:
    """int8_matmul calls by instance: decode (M <= 16), mixed step."""
    return {"decode_m_le_16": sum(n for m, n in by_m.items() if m <= 16),
            "mixed_step_m_gt_16": sum(n for m, n in by_m.items() if m > 16)}


def spec_wave(port: int, model: str, backend, bodies: list,
              at_once: bool = True, gaps: bool = False) -> dict:
    """Send ``bodies`` (all at once, else one after another) to one model;
    each request's ids and text (``EngineSpy``), host clocks of decode
    steps and spec dispatches, the engine's counters over the run, and
    the kernels' launches with every count set to 0 just before it:
    attention must have launched once per layer of every target forward
    (verify forwards included) and of every draft forward."""
    import threading

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    eng = backend.engine
    spy = EngineSpy(eng, gaps=True)
    sspy = SpecSpy(eng, gaps=gaps) if eng.draft is not None else None
    by_m, undo = _b2_by_m(eng)
    errors: list = []
    statuses: dict = {}

    def send(i):
        status, text = _post(port, {"model": model, **bodies[i]})
        statuses[i] = status
        if status != 200:
            errors.append(f"request {i}: HTTP {status} {text[:200]}")

    m0 = dict(vars(eng.metrics))
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.perf_counter()
    try:
        if at_once:
            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(bodies))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
        else:
            for i in range(len(bodies)):
                send(i)
        wall = time.perf_counter() - t0
        launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
    finally:
        undo()
        spy.close()
        if sspy is not None:
            sspy.close()
    if errors or len(statuses) != len(bodies):
        raise AssertionError(f"{model}: spec wave failed: {errors}")
    m = {k: v - m0[k] for k, v in vars(eng.metrics).items()}
    check_spec_launches(eng, m, launches, by_m, model)
    deadline = time.time() + 30
    while any(s.active for s in eng.slots) and time.time() < deadline:
        time.sleep(0.01)
    eng.leak_check()
    steps = spy.step_ms()
    rounds = m["spec_rounds"]
    out = {
        "model": model, "requests": len(bodies), "at_once": at_once,
        "wall_s": wall, "forward_steps": m["forward_steps"],
        "draft_forwards": m["draft_forwards"],
        "decode_forwards": m["decode_steps"],
        "spec_dispatches": m["spec_dispatches"],
        "spec_tokens": m["spec_tokens"], "spec_rounds": rounds,
        "spec_accepted": m["spec_accepted"],
        "accepted_per_round": m["spec_accepted"] / max(1, rounds),
        "acceptance_rate": m["spec_accepted"] / max(
            1, rounds * (eng.n_draft - 1)),
        "host_ms_per_spec_dispatch": (
            sspy.seconds * 1e3 / max(1, sspy.dispatches) if sspy else None),
        "host_ms_per_decode_forward": steps["plain_host_ms_per_forward"],
        "launches": launches,
        "int8_matmul_calls_by_m": dict(sorted(by_m.items())),
    }
    out["_done"], out["_gaps"], out["_first"] = (
        spy.done, spy.gaps(), spy.first_logits)
    out["_spec_rows"] = sspy.rows if sspy else set()
    out["_rejection_gaps"] = sspy.rejection_gaps() if sspy else []
    return out


SPEC_MODES = ("graph", "body")


def spec_pair(app, model: str, backend, waves: list,
              gaps: bool = False) -> dict:
    """``waves`` (lists of request bodies, served in turn, each in one
    admission wave) stepped by hand (one schedule) on a fresh engine
    twice: ``graph`` as served (every speculative dispatch a replay of
    its variant's graph) and ``body`` with the same variant bodies run
    eagerly (``_spec_launch = _spec_body``). Per wave the ids must be
    bitwise equal and B1's and B2's launches per replay equal to theirs
    per call; ``gaps`` takes the greedy rejection gaps in the body run.
    Per mode and wave: the spec_wave fields, host ms per spec dispatch
    and replays; and the graph engine's warmup, variants and graph
    pool."""
    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    out: dict = {}
    for mode in SPEC_MODES:
        eng = fresh_engine(backend, True)
        if mode == "graph":
            out["warmup"] = {
                "warmup_s": eng.metrics.warmup_s,
                "variants": eng.variant_count(),
                "spec_variants": len(eng._spec_variants),
                "graph_pool_bytes": eng._graph_pool_bytes}
        else:
            eng._spec_launch = eng._spec_body
        out[mode] = []
        for bodies in waves:
            spy = EngineSpy(eng, gaps=True)
            sspy = SpecSpy(eng, gaps=gaps and mode == "body")
            by_m, undo = _b2_by_m(eng)
            m0 = dict(vars(eng.metrics))
            torch.cuda.synchronize()
            ragged_paged_attention.launches = 0
            int8_matmul.launches = 0
            t0 = time.perf_counter()
            try:
                _serve_by_hand(eng, burst_requests(
                    app, model, backend,
                    [{"model": model, **b} for b in bodies]), [])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {
                    "ragged_paged_attention":
                        ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
            finally:
                undo()
                spy.close()
                sspy.close()
            m = {k: v - m0[k] for k, v in vars(eng.metrics).items()}
            check_spec_launches(eng, m, launches, by_m,
                                f"{model} spec {mode}")
            rounds = m["spec_rounds"]
            out[mode].append({
                "requests": len(bodies), "wall_s": wall,
                "forward_steps": m["forward_steps"],
                "draft_forwards": m["draft_forwards"],
                "decode_forwards": m["decode_steps"],
                "spec_dispatches": m["spec_dispatches"],
                "spec_replays": m["spec_replays"],
                "spec_tokens": m["spec_tokens"], "spec_rounds": rounds,
                "spec_accepted": m["spec_accepted"],
                "acceptance_rate": m["spec_accepted"] / max(
                    1, rounds * (eng.n_draft - 1)),
                "host_ms_per_spec_dispatch":
                    sspy.seconds * 1e3 / max(1, sspy.dispatches),
                "launches": launches,
                "int8_matmul_calls_by_m": dict(sorted(by_m.items())),
                "_done": spy.done, "_gaps": spy.gaps(),
                "_first": spy.first_logits,
                "_rejection_gaps": sspy.rejection_gaps()})
    # the worker serves on with the last engine: replays, own thread
    backend.engine.__dict__.pop("_spec_launch", None)
    backend.engine._autostart = True
    for i, (g, b) in enumerate(zip(out["graph"], out["body"])):
        apart = [len(p) for p in g["_done"]
                 if g["_done"][p]["ids"] != b["_done"][p]["ids"]]
        if apart or len(g["_done"]) != len(waves[i]):
            raise AssertionError(f"{model} wave {i}: spec replay and body "
                                 f"differ for prompts of {apart} tokens")
        if g["launches"] != b["launches"] or \
                g["int8_matmul_calls_by_m"] != b["int8_matmul_calls_by_m"]:
            raise AssertionError(
                f"{model} wave {i}: spec launches per replay "
                f"{g['launches']} != per call {b['launches']}")
        on_card = backend.engine.device.type == "cuda"
        if not g["spec_dispatches"] or b["spec_replays"] or (
                on_card and g["spec_replays"] != g["spec_dispatches"]):
            raise AssertionError(
                f"{model} wave {i}: {g['spec_replays']} replays of "
                f"{g['spec_dispatches']} spec dispatches")
    out["ids_bitwise_equal"] = [len(g["_done"]) for g in out["graph"]]
    return out


def _pair_public(pair: dict) -> dict:
    return {k: ([_public(w) for w in v] if k in SPEC_MODES else v)
            for k, v in pair.items()}


def check_spec_launches(eng, m: dict, launches: dict, by_m: dict,
                        what: str) -> None:
    """Attention must have launched once per layer of every target and
    draft forward of the run (counters ``m``), and int8_matmul once per
    call counted by M (a CPU dry run launches none)."""
    if eng.device.type != "cuda":
        return
    draft_layers = eng.draft[0].n_layers if eng.draft is not None else 0
    want = eng.spec.n_layers * m["forward_steps"] \
        + draft_layers * m["draft_forwards"]
    if launches["ragged_paged_attention"] != want:
        raise AssertionError(
            f"{what}: ragged_paged_attention launched "
            f"{launches['ragged_paged_attention']} times for "
            f"{m['forward_steps']} target and {m['draft_forwards']} draft "
            "forwards")
    if sum(by_m.values()) != launches["int8_matmul"]:
        raise AssertionError(
            f"{what}: int8_matmul launched {launches['int8_matmul']} "
            f"times for {sum(by_m.values())} calls")


def _public(w: dict) -> dict:
    return {k: v for k, v in w.items() if not k.startswith("_")}


def _greedy_only(w: dict) -> dict:
    """The wave's greedy requests only (sampled ones differ by batch)."""
    return {**w, "_done": {p: d for p, d in w["_done"].items()
                           if d["greedy"]}}


def _loaded(port: int, app, model: str):
    """Load ``model`` through the server (a short warm request) and
    return its worker."""
    warm = {"model": model, "max_tokens": 4,
            "messages": [{"role": "user", "content": "warm up"}]}
    check_reply(f"{model} load", warm, *_http(port, warm))
    return app.loaded()[model]


def _serve(models: Path):
    import threading

    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(models), port=0, device=CARD)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def _shut(srv, th) -> None:
    import gc

    import torch

    srv.close()
    th.join(timeout=30)
    gc.collect()
    torch.cuda.empty_cache()


def phase_spec(ckpt_name: str, seed: int) -> dict:
    """Speculative decoding through the HTTP route: (a) the 8B
    checkpoint's first SPEC_B_LAYERS layers with a Llama-3.2-1B-geometry
    draft against the plain model of that depth, greedy;
    (b) the 8B checkpoint's first SPEC_B_LAYERS layers as their own
    draft, greedy and sampled; (c) the int8 target at that depth with
    the bf16 1B draft; (d) a penalised request beside a clean one on
    (a)'s server."""
    models = ROOT / "build" / "chip_smoke" / "models"
    layers = DRAFT_GEOMETRY["num_hidden_layers"]
    draft_name = f"llama32-1b-geometry-L{layers}-s{DRAFT_SEED}"
    written, write_s = write_checkpoint(models / draft_name, layers,
                                        DRAFT_SEED, DRAFT_GEOMETRY)
    log("spec_checkpoint", dir=draft_name, written=written,
        write_s=write_s, layers=layers)
    cut = first_layers(models, ckpt_name, SPEC_B_LAYERS)
    config = json.loads((models / ckpt_name / "config.json").read_text())
    configs = {"llama-3.1-8b-spec": {"model": cut,
                                     "draft_model": draft_name},
               "llama-3.1-8b-self": {"model": cut, "draft_model": cut},
               "llama-3.1-8b-cut": {"model": cut},
               "llama-3.1-8b-int8-spec": {"model": cut,
                                          "draft_model": draft_name,
                                          "quantization": "int8"},
               "llama-3.1-8b-cut-int8": {"model": cut,
                                         "quantization": "int8"}}
    for name, extra in configs.items():
        model = extra.pop("model", ckpt_name)
        (models / f"{name}.yaml").write_text(json.dumps({
            "name": name, "backend": "torch-llm",
            "parameters": {"model": model, "temperature": 0.0,
                           "max_tokens": 32},
            "context_size": CONTEXT, "max_batch_slots": SLOTS,
            "dtype": "bfloat16", "n_draft": N_DRAFT, **extra,
            "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                         "chat": "{{.Input}}\nassistant:"},
        }, indent=1))
    first, later = burst_bodies()
    greedy = [{**b, "temperature": 0.0} for _, b in first + later]
    out = {}

    # (a) the 1B draft for the 8B checkpoint's first SPEC_B_LAYERS layers
    # (a depth cut that keeps the default run in its time budget) against
    # the plain model of that depth; (d) on the same server
    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        plain_b = _loaded(port, srv.app, "llama-3.1-8b-cut")
        spec_b = _loaded(port, srv.app, "llama-3.1-8b-spec")
        if spec_b.engine.draft is None or spec_b.engine.n_draft != N_DRAFT:
            raise AssertionError("llama-3.1-8b-spec served without its draft")
        plain = spec_wave(port, "llama-3.1-8b-cut", plain_b, greedy)
        spec = spec_wave(port, "llama-3.1-8b-spec", spec_b, greedy)
        cmp = compare_waves(spec, plain, plain_b.engine, "spec vs plain")
        if cmp["faults"] or not spec["spec_dispatches"]:
            raise AssertionError(f"(a) spec against plain: {cmp['faults']}, "
                                 f"{spec['spec_dispatches']} dispatches")
        out["a"] = {"plain": _public(plain), "spec": _public(spec),
                    "compare": cmp, "layers": SPEC_B_LAYERS,
                    "reduced": f"target layers {SPEC_B_LAYERS} of "
                               f"{GEOMETRY['num_hidden_layers']}"}
        log("spec_a", **out["a"])
        # the same burst by replay and by the variant bodies eagerly
        pair = spec_pair(srv.app, "llama-3.1-8b-spec", spec_b, [greedy])
        g = pair["graph"][0]
        out["a_graphs"] = {
            **_pair_public(pair),
            "host_ms_per_spec_dispatch_replay":
                g["host_ms_per_spec_dispatch"],
            "host_ms_per_spec_dispatch_body_eagerly":
                pair["body"][0]["host_ms_per_spec_dispatch"],
            "host_ms_per_plain_decode_forward":
                plain["host_ms_per_decode_forward"]}
        log("spec_a_graphs", **out["a_graphs"])
        clean = {"max_tokens": 24, "temperature": 0.0, "messages": [
            {"role": "user", "content": "Say hello."}]}
        pen = {"max_tokens": 24, "temperature": 0.0, "repeat_penalty": 1.3,
               "messages": [{"role": "user", "content": "Count to ten."}]}
        alone = [spec_wave(port, "llama-3.1-8b-spec", spec_b, [b])
                 for b in (clean, pen)]
        pair = spec_wave(port, "llama-3.1-8b-spec", spec_b, [clean, pen])
        singles = {k: {**alone[0][k], **alone[1][k]}
                   for k in ("_done", "_gaps", "_first")}
        cmp_d = compare_waves(pair, singles, plain_b.engine,
                              "pair vs singles")
        in_spec = {p: p in pair["_spec_rows"] for p in pair["_done"]}
        pen_prompt = next(iter(alone[1]["_done"]))
        clean_prompt = next(iter(alone[0]["_done"]))
        if (cmp_d["faults"] or in_spec.get(pen_prompt)
                or not in_spec.get(clean_prompt)
                or pair["decode_forwards"] == 0):
            raise AssertionError(
                f"(d) per-slot eligibility: penalised in spec "
                f"{in_spec.get(pen_prompt)}, clean in spec "
                f"{in_spec.get(clean_prompt)}, {pair['decode_forwards']} "
                f"decode forwards, faults {cmp_d['faults']}")
        out["d"] = {"pair": _public(pair), "compare": cmp_d,
                    "penalised_in_spec": False, "clean_in_spec": True}
        log("spec_d", **out["d"])
    finally:
        _shut(srv, th)

    # (b) the 8B checkpoint's first SPEC_B_LAYERS layers drafting for
    # themselves, the four prompts at once (decode rows run through the
    # later prompts' mixed steps, which write their draft K/V too); its
    # greedy ids held to the plain model of that depth
    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        cut_b = _loaded(port, srv.app, "llama-3.1-8b-cut")
        plain_cut = spec_wave(port, "llama-3.1-8b-cut", cut_b, greedy)
        self_b = _loaded(port, srv.app, "llama-3.1-8b-self")
        sampled = [{**b, "temperature": 1.0, "seed": 11 + i}
                   for i, b in enumerate(greedy)]
        # greedy, then sampled, each by replay and by the bodies eagerly
        # (the body run reads the greedy rejection gaps)
        pair = spec_pair(srv.app, "llama-3.1-8b-self", self_b,
                         [greedy, sampled], gaps=True)
        g, s_ = pair["graph"]
        gaps = pair["body"][0]["_rejection_gaps"]
        cmp_b = compare_waves(g, plain_cut, self_b.engine,
                              "self-draft vs plain")
        out["b"] = {**_pair_public(pair), "layers": SPEC_B_LAYERS,
                    "reduced": f"layers {SPEC_B_LAYERS} of "
                               f"{config['num_hidden_layers']}",
                    "greedy": _public(g), "sampled": _public(s_),
                    "compare": cmp_b, "greedy_rejections": len(gaps),
                    "greedy_rejection_gap_max": max(gaps, default=0.0),
                    "limit": REJECT_TIE, "sampled_min": SAMPLED_ACCEPT_MIN}
        log("spec_b", **out["b"])
        if cmp_b["faults"]:
            raise AssertionError(f"(b) self-draft against plain: "
                                 f"{cmp_b['faults']}")
        if any(x > REJECT_TIE for x in gaps):
            raise AssertionError(f"(b) a greedy rejection off a near tie: "
                                 f"{sorted(gaps)[-5:]}")
        if s_["acceptance_rate"] < SAMPLED_ACCEPT_MIN:
            raise AssertionError(f"(b) sampled acceptance "
                                 f"{s_['acceptance_rate']}")
        # the same checks on planted faults, with prompts no resident
        # prefix serves (so the faulted mirror is what the draft reads)
        out["b_planted"] = {}
        for kind in SPEC_FAULTS:
            undo = plant_spec_fault(self_b.engine, kind)
            try:
                fresh = [{**b, "messages": [{"role": "user", "content":
                          f"{kind} {i}: {b['messages'][-1]['content']}"}]}
                         for i, b in enumerate(greedy)]
                fg = spec_wave(port, "llama-3.1-8b-self", self_b, fresh,
                               gaps=True)
                fs = spec_wave(port, "llama-3.1-8b-self", self_b, [
                    {**b, "temperature": 1.0, "seed": 11 + i,
                     "messages": [{"role": "user", "content":
                                   "sampled " + b["messages"][-1]["content"]}]}
                    for i, b in enumerate(fresh)])
            finally:
                undo()
            fgaps = fg["_rejection_gaps"]
            out["b_planted"][kind] = {
                "greedy_acceptance": fg["acceptance_rate"],
                "greedy_rejections": len(fgaps),
                "greedy_rejection_gap_max": max(fgaps, default=0.0),
                "sampled_acceptance": fs["acceptance_rate"],
                "greedy_check_fails": any(x > REJECT_TIE for x in fgaps),
                "sampled_check_fails":
                    fs["acceptance_rate"] < SAMPLED_ACCEPT_MIN}
            log("spec_b_planted", fault=kind, **out["b_planted"][kind])
        missed = [k for k, key in (
            ("stale_draft_arena", "greedy_check_fails"),
            ("p_one_position_late", "sampled_check_fails"))
            if not out["b_planted"][k][key]]
        if missed:
            raise AssertionError(f"(b) planted faults passed their check: "
                                 f"{missed}")
    finally:
        _shut(srv, th)

    # (c) the int8 target, the 8B checkpoint's first SPEC_B_LAYERS layers
    # quantized at load (a depth cut that keeps the default run in its
    # time budget; no artifact is written), and
    # the bf16 draft: one greedy request (verify M = 4, B2's decode
    # instance), then 8 at once, greedy and sampled (M = 32, its
    # mixed-step one); the greedy ids held to the plain int8 model's of
    # that depth on the same bodies
    saved = os.environ.get("LOCALAI_QUANT_ARTIFACTS")
    os.environ["LOCALAI_QUANT_ARTIFACTS"] = "off"
    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        q_b = _loaded(port, srv.app, "llama-3.1-8b-int8-spec")
        qp_b = _loaded(port, srv.app, "llama-3.1-8b-cut-int8")
        if (q_b.load_mode, qp_b.load_mode) != ("quantized", "quantized"):
            raise AssertionError(f"(c) load modes {q_b.load_mode}, "
                                 f"{qp_b.load_mode}")
        one = spec_wave(port, "llama-3.1-8b-int8-spec", q_b, greedy[:1])
        one_plain = spec_wave(port, "llama-3.1-8b-cut-int8", qp_b,
                              greedy[:1])
        burst = [{"max_tokens": 32, "messages": [
            {"role": "user", "content": f"Request {i}: name a colour."}],
            **({"temperature": 0.8, "seed": i} if i % 2 else
               {"temperature": 0.0})} for i in range(SLOTS)]
        eight = spec_wave(port, "llama-3.1-8b-int8-spec", q_b, burst)
        eight_plain = spec_wave(port, "llama-3.1-8b-cut-int8", qp_b,
                                burst)
        cmp_c = {"one": compare_waves(one, one_plain, qp_b.engine,
                                      "int8 spec vs plain, one"),
                 "eight_greedy": compare_waves(
                     _greedy_only(eight), _greedy_only(eight_plain),
                     qp_b.engine, "int8 spec vs plain, eight")}
        m4 = one["int8_matmul_calls_by_m"].get(N_DRAFT, 0)
        m32 = eight["int8_matmul_calls_by_m"].get(SLOTS * N_DRAFT, 0)
        # one request, then the eight, by replay and by the bodies eagerly
        pair = spec_pair(srv.app, "llama-3.1-8b-int8-spec", q_b,
                         [greedy[:1], burst])
        out["c"] = {"one": _public(one), "eight": _public(eight),
                    "plain_one": _public(one_plain),
                    "plain_eight": _public(eight_plain), "compare": cmp_c,
                    "verify_m4_calls": m4, "verify_m32_calls": m32,
                    "graphs": _pair_public(pair), "layers": SPEC_B_LAYERS,
                    "reduced": f"layers {SPEC_B_LAYERS} of "
                               f"{GEOMETRY['num_hidden_layers']}"}
        log("spec_c", **out["c"])
        faults = [c["faults"] for c in cmp_c.values() if c["faults"]]
        if faults or cmp_c["eight_greedy"]["requests"] != SLOTS // 2:
            raise AssertionError(f"(c) int8 spec against plain: {faults}")
        if not (m4 and m32 and one["spec_dispatches"]
                and eight["spec_dispatches"]):
            raise AssertionError(f"(c) B2 in verify forwards: M=4 {m4}, "
                                 f"M=32 {m32}")
    finally:
        _shut(srv, th)
        if saved is None:
            os.environ.pop("LOCALAI_QUANT_ARTIFACTS", None)
        else:
            os.environ["LOCALAI_QUANT_ARTIFACTS"] = saved
    return out


# ------------------------------------------------------------ phase 10

# Llama-3's 256 special tokens, in id order from 128000
# (<|begin_of_text|> 128000, <|eot_id|> 128009)
LLAMA3_SPECIALS = [
    "<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
    "<|reserved_special_token_2|>", "<|start_header_id|>",
    "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>",
    *(f"<|reserved_special_token_{3 + k}|>" for k in range(245)),
]
# Llama-3's pre-tokenizer pattern (its tokenizer.json Split)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|"
                r"\s+")
# a Llama-3-style chat template, written for this script: a system turn
# with the date and the tools, a raise on an unknown role, the turns
TEXT_CHAT_TEMPLATE = """{{- bos_token }}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content'] | trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{%- set ns = namespace(tool_turns=0, users=0) %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none %}
    {{- "You may call these functions. Reply with JSON {\\"name\\": ..., \\"arguments\\": ...}.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}
{%- for message in messages %}
    {%- if message.role not in ['user', 'assistant', 'tool', 'ipython'] %}
        {{- raise_exception("unknown role: " ~ message.role) }}
    {%- endif %}
    {%- if message.role == 'user' %}
        {%- set ns.users = ns.users + 1 %}
    {%- endif %}
    {%- if message.role in ['tool', 'ipython'] %}
        {%- set ns.tool_turns = ns.tool_turns + 1 %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable and message.content is not string %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- elif message.tool_calls is defined and message.tool_calls %}
        {{- "<|start_header_id|>assistant<|end_header_id|>\\n\\n" }}
        {%- for call in message.tool_calls %}
            {%- set fn = call.function if call.function is defined else call %}
            {{- '{"name": "' + fn.name + '", "arguments": ' }}
            {{- fn.arguments | tojson if fn.arguments is not string else fn.arguments }}
            {{- "}" }}
        {%- endfor %}
        {{- "<|eot_id|>" }}
    {%- else %}
        {{- "<|start_header_id|>" + message.role + "<|end_header_id|>\\n\\n" + message.content | trim + "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- "<|start_header_id|>assistant<|end_header_id|>\\n\\n" }}
{%- endif %}
"""


def _byte_alphabet() -> list[str]:
    """GPT-2's byte-level alphabet, byte 0 first."""
    keep = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD))
            + list(range(0xAE, 0x100)))
    out, k = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + k)
            k += 1
    return [out[b] for b in range(256)]


def text_vocab(vocab_size: int = 128256,
               n_special: int = len(LLAMA3_SPECIALS)) -> tuple[dict, list]:
    """(vocab, merges) of the generated byte-level BPE: the 256 byte
    symbols, then merges of printable ASCII, space and newline symbols up
    to id ``vocab_size - n_special`` (the special tokens take the rest:
    Llama-3's 256 by default)."""
    vocab = {c: i for i, c in enumerate(_byte_alphabet())}
    base = [chr(b) for b in range(0x21, 0x7F)] + ["Ġ", "Ċ"]
    n_merged = vocab_size - n_special
    merges: list[list[str]] = []
    level = list(base)
    while len(vocab) < n_merged:
        nxt = []
        for a in level:
            for b in base:
                if len(vocab) >= n_merged:
                    break
                if a + b in vocab:
                    continue
                vocab[a + b] = len(vocab)
                merges.append([a, b])
                nxt.append(a + b)
        level = nxt
    return vocab, merges


def write_text_tokenizer(dirpath: Path, vocab_size: int = 128256) -> dict:
    """A byte-level BPE ``tokenizer.json`` with Llama-3's layout, written
    without the ``tokenizers`` package: the 256 byte symbols, merges of
    printable ASCII, space and newline symbols generated up to id
    ``vocab_size - 256`` (so a sampled id decodes to visible text), and
    Llama-3's 256 special tokens above them (128000-128255 at the 8B's
    vocabulary); the Llama-3 ``Split`` pattern, ``ignore_merges`` and the
    ``ByteLevel`` decoder. Also ``tokenizer_config.json``
    (``clean_up_tokenization_spaces`` and the chat template above) and
    ``generation_config.json`` (eos ``<|end_of_text|>`` and
    ``<|eot_id|>``)."""
    vocab, merges = text_vocab(vocab_size)
    n_merged = len(vocab)
    added = [{"id": n_merged + k, "content": c, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for k, c in enumerate(LLAMA3_SPECIALS)]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }
    dirpath.mkdir(parents=True, exist_ok=True)
    (dirpath / "tokenizer.json").write_text(json.dumps(spec,
                                                       ensure_ascii=False))
    (dirpath / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
        "clean_up_tokenization_spaces": True,
        "model_max_length": 131072,
        "chat_template": TEXT_CHAT_TEMPLATE,
    }, indent=1))
    (dirpath / "generation_config.json").write_text(json.dumps({
        "bos_token_id": n_merged, "eos_token_id": [n_merged + 1,
                                                   n_merged + 9]}))
    return {"vocab": len(vocab) + len(added), "merges": len(merges)}


TEXT_MODEL = "llama-3.1-8b-text"
TEXT_DIR = "llama31-8b-text"
# a real-YAML model config: the tokenizer's chat template, block-scalar
# completion and edit templates, and a trimsuffix
TEXT_YAML = f"""# Llama-3.1-8B geometry with its tokenizer.json and chat template
name: {TEXT_MODEL}
backend: torch-llm
parameters:
  model: {TEXT_DIR}
  temperature: 0.0
  max_tokens: 24
context_size: {CONTEXT}
max_batch_slots: {SLOTS}
dtype: bfloat16
trimsuffix:
  - "<|eot_id|>"
template:
  use_tokenizer_template: yes
  completion: |-
    {{{{.Input}}}}
  edit: |
    Instruction: {{{{.Instruction}}}}
    Input: {{{{.Input}}}}
    Output:
"""
TEXT_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "The weather of a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}}]
# the chat request whose time to first token is read on both tokenizers
# (sent nowhere else, so neither model holds its prompt when it comes)
TEXT_TTFT_BODY = {"stream": True, "max_tokens": 8, "messages": [
    {"role": "system", "content": "You are a terse assistant."},
    {"role": "user", "content": "Explain how a paged KV cache grows. " * 8}]}


def text_bodies() -> list:
    """Phase text's chat burst: (name, body)."""
    return [
        ("plain", {"stream": True, "max_tokens": 24, "messages": [
            {"role": "user", "content": "Say hello, then count to five."}]}),
        ("system", {"stream": True, "max_tokens": 24, "messages": [
            {"role": "system", "content": " You answer briefly. "},
            {"role": "user", "content": "It 's a test , isn't it ?"},
            {"role": "assistant", "content": "It is."},
            {"role": "user", "content": "Über café 中文 🎉, why?"}]}),
        ("tools", {"stream": True, "max_tokens": 48,
                   "messages": [{"role": "user",
                                 "content": "What is the weather in Paris?"}],
                   "tools": TEXT_TOOLS}),
    ]


def stream_post(port: int, path: str, body: dict,
                headers: dict | None = None) -> dict:
    """A streamed request read frame by frame: the frames (each checked
    to be a ``data:`` JSON object, the last ``[DONE]``), the text they
    carry and the host ms to the first frame with text."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    ttft = None
    frames, texts = [], []
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200 or not r.headers.get(
                "Content-Type", "").startswith("text/event-stream"):
            raise AssertionError(f"{path}: HTTP {r.status}")
        buf = b""
        while True:
            line = r.readline()
            if not line:
                break
            buf += line
            if not buf.endswith(b"\n\n"):
                continue
            frame, buf = buf.decode().rstrip("\n"), b""
            if not frame.startswith("data: "):
                raise AssertionError(f"{path}: bad SSE frame {frame[:80]!r}")
            if frame == "data: [DONE]":
                frames.append(None)
                continue
            if frames and frames[-1] is None:
                raise AssertionError(f"{path}: a frame after [DONE]")
            obj = json.loads(frame[len("data: "):])
            choice = obj["choices"][0]
            text = choice.get("text") or (choice.get("delta") or {}).get(
                "content") or ""
            if text and ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            frames.append(obj)
            texts.append(text)
    if not frames or frames[-1] is not None or buf:
        raise AssertionError(f"{path}: stream does not end in [DONE]")
    return {"frames": frames[:-1], "text": "".join(texts), "ttft_ms": ttft}


def post_json(port: int, path: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return json.loads(r.read().decode())


def text_ttft(port: int, model: str, eng) -> dict:
    """TEXT_TTFT_BODY streamed alone: host ms to the first frame with
    text (None when no sampled id decodes to text, as on a byte tokenizer
    over a 128256-id vocabulary), the engine's submit-to-first-token ms
    and prompt tokens from the final frame's usage, and the prompt
    tokens the engine computed (the rest it reused)."""
    filled = eng.metrics.prefill_tokens
    res = stream_post(port, "/v1/chat/completions",
                      {"model": model, **TEXT_TTFT_BODY},
                      {"Extra-Usage": "1"})
    usage = res["frames"][-1]["usage"]
    return {"ttft_ms": res["ttft_ms"],
            "engine_first_token_ms": usage["timing_first_token"],
            "prompt_tokens": usage["prompt_tokens"],
            "prompt_tokens_computed": eng.metrics.prefill_tokens - filled,
            "chars": len(res["text"])}


class _FinalTap:
    """An engine event queue that hands each request's whole generated
    text (its final event's ``full_text``) to ``record``."""

    def __init__(self, q, record) -> None:
        self._q = q
        self._record = record

    def _seen(self, ev):
        if ev.done:
            self._record(ev.full_text)
        return ev

    def get(self, *a, **kw):
        return self._seen(self._q.get(*a, **kw))

    def get_nowait(self):
        return self._seen(self._q.get_nowait())


def _median(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def text_host_costs(backend, prompts: list, grammar: str) -> dict:
    """Host-clock costs of the text layer on this tokenizer: load, chat
    template render, encode (cold and warm word cache), the grammar's
    vocabulary table, and the stream decoder per token."""
    from localai_tfp_tpu_torch.engine.tokenizer import (StreamDecoder,
                                                        load_tokenizer)
    from localai_tfp_tpu_torch.grammars.native import make_constraint

    ckpt = ROOT / "build" / "chip_smoke" / "models" / TEXT_DIR
    t0 = time.perf_counter()
    tk = load_tokenizer(str(ckpt))
    load_s = time.perf_counter() - t0
    msgs = text_bodies()[1][1]["messages"]
    render = []
    for _ in range(20):
        t = time.perf_counter()
        tk.apply_chat_template(msgs, add_generation_prompt=True)
        render.append((time.perf_counter() - t) * 1e3)
    out = {"tokenizer_load_s": load_s,
           "template_render_ms_p50": _median(render)}
    for label in ("cold", "warm"):
        t = time.perf_counter()
        n = sum(len(tk.encode(p, add_bos=True)) for p in prompts)
        out[f"encode_tok_per_s_{label}"] = n / (time.perf_counter() - t)
        out["encode_tokens"] = n
    t = time.perf_counter()
    make_constraint(grammar, backend.tokenizer)
    out["grammar_table_s"] = time.perf_counter() - t
    ids = tk.encode(" ".join(prompts))[:512]
    dec = StreamDecoder(tk)
    t = time.perf_counter()
    for i in ids:
        dec.push(i)
    out["decode_us_per_token"] = (time.perf_counter() - t) * 1e6 / len(ids)
    out["decode_tokens"] = len(ids)
    return out


def phase_text(ckpt_name: str, byte_ttft: dict, smi: str) -> dict:
    """The 8B checkpoint served through a second model directory with a
    generated Llama-3-layout tokenizer.json, its chat template and a
    real-YAML config: a chat burst (one with tools), a completion
    streamed and whole with echo, an edit, a tokenize, a grammar request;
    the prompt ids against the port's encode(apply_chat_template(...)),
    the SSE frames, streamed against whole text, attention's launches;
    the host costs of the layer."""
    import threading

    import torch

    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "models"
    ckpt = models / TEXT_DIR
    if ckpt.is_dir():
        for p in ckpt.iterdir():
            p.unlink()
    ckpt.mkdir(parents=True, exist_ok=True)
    for fname in ("model.safetensors", "config.json"):
        (ckpt / fname).symlink_to(models / ckpt_name / fname)
    tok_info = write_text_tokenizer(ckpt)
    (models / f"{TEXT_MODEL}.yaml").write_text(TEXT_YAML)
    # each prompt computed whole: a streamed request and its whole twin,
    # each alone, run the same shapes
    os.environ["LOCALAI_PREFIX_CACHE"] = "off"
    srv, th = _serve(models)
    port = srv.server_address[1]
    try:
        t0 = time.perf_counter()
        warm = post_json(port, "/v1/chat/completions", {
            "model": TEXT_MODEL, "max_tokens": 4,
            "messages": [{"role": "user", "content": "warm up"}]})
        load_s = time.perf_counter() - t0
        backend = srv.app.loaded()[TEXT_MODEL]
        cfg = srv.app.config_loader.get(TEXT_MODEL)
        tk = backend.tokenizer
        if type(tk).__name__ != "HFTokenizer" or tk.vocab_size != 128256:
            raise AssertionError(f"text model tokenizer {type(tk).__name__}"
                                 f" vocab {tk.vocab_size}")
        if cfg.trimsuffix != ["<|eot_id|>"]:
            raise AssertionError(f"YAML config read as {cfg}")
        from localai_tfp_tpu_torch.grammars.parse import apply_finetune

        def finetuned(text: str) -> str:
            return apply_finetune(text, trimsuffix=cfg.trimsuffix)

        seen: list = []
        whole: dict = {}  # prompt ids -> each request's engine text
        orig = backend._to_request
        eng = backend.engine
        submit = eng.submit

        def spy(opts):
            req = orig(opts)
            seen.append((opts.prompt, list(req.prompt_ids)))
            return req

        def tapped(req):
            texts = whole.setdefault(tuple(req.prompt_ids), [])
            return _FinalTap(submit(req), texts.append)
        backend._to_request = spy
        eng.submit = tapped
        ragged_paged_attention.launches = 0
        # (a) the chat burst, all at once
        results: dict = {}
        errors: list = []

        def send(name, body):
            try:
                results[name] = stream_post(port, "/v1/chat/completions",
                                            {"model": TEXT_MODEL, **body})
            except Exception as e:  # re-raised below
                errors.append(f"{name}: {e!r}")
        threads = [threading.Thread(target=send, args=a)
                   for a in text_bodies()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(results) != len(threads):
            raise AssertionError(f"text chat burst failed: {errors}")
        for name, body in text_bodies():
            tools = [t["function"] for t in body.get("tools") or []]
            want = tk.encode(tk.apply_chat_template(
                body["messages"], add_generation_prompt=True,
                tools=tools or None), add_bos=True)
            if not any(ids == want for _, ids in seen):
                raise AssertionError(f"{name}: the engine's prompt ids are "
                                     "not encode(apply_chat_template(...))")
            if not tools and results[name]["text"] != finetuned(
                    whole[tuple(want)][0]):
                raise AssertionError(f"{name}: the streamed text is not the "
                                     "whole reply")
            fr = results[name]["frames"]
            if fr[0]["choices"][0]["delta"] != {"role": "assistant",
                                               "content": ""}:
                raise AssertionError(f"{name}: first delta is not the role")
            if any(f["object"] != "chat.completion.chunk" for f in fr):
                raise AssertionError(f"{name}: wrong chunk object")
        # (b) a chat and a completion streamed, then whole, each alone:
        # each reply's text is its own generation's whole text (the
        # second request reuses the first's resident prompt in its slot,
        # so the two generations need not agree token for token)
        pairs = {}
        for path, body in (
                ("/v1/chat/completions", {**text_bodies()[0][1]}),
                ("/v1/completions", {"prompt": "The paged arena holds",
                                     "max_tokens": 16, "echo": True})):
            body = {"model": TEXT_MODEL, **body, "stream": True}
            n0 = len(seen)
            s = stream_post(port, path, body, {"Extra-Usage": "1"})
            w = post_json(port, path, {**body, "stream": False})
            ids = tuple(seen[n0][1])
            raw = whole[ids][-2:]
            wc = w["choices"][0]
            text = wc["message"]["content"] if "message" in wc else \
                wc["text"]
            if path == "/v1/completions":
                if not text.startswith(body["prompt"]):
                    raise AssertionError("echo did not prepend the prompt")
                text = text[len(body["prompt"]):]
            if s["text"] != finetuned(raw[0]) or text != finetuned(raw[1]):
                raise AssertionError(f"{path}: streamed {s['text']!r} / "
                                     f"whole {text!r} against the engine's "
                                     f"{raw!r}")
            if "timing_prompt_processing" not in s["frames"][-1]["usage"]:
                raise AssertionError(f"{path}: no extra usage")
            pairs[path] = {"ttft_ms": s["ttft_ms"], "chars": len(text),
                           "same_generation": raw[0] == raw[1]}
        # (c) an edit, a tokenize, a grammar request
        edit = post_json(port, "/v1/edits", {
            "model": TEXT_MODEL, "instruction": "Fix the spelling",
            "input": "teh cat sat", "max_tokens": 12})
        if edit["object"] != "edit" or len(edit["choices"]) != 1:
            raise AssertionError(f"edit reply {edit}")
        text = "Hello, world! It's 2024 <|eot_id|>"
        tok = post_json(port, "/v1/tokenize", {"model": TEXT_MODEL,
                                               "content": text})
        if tok["tokens"] != tk.encode(text) or 128009 not in tok["tokens"]:
            raise AssertionError(f"tokenize gave {tok}")
        grammar = 'root ::= "yes" | "no" | "maybe"'
        g = post_json(port, "/v1/chat/completions", {
            "model": TEXT_MODEL, "max_tokens": 8, "grammar": grammar,
            "messages": [{"role": "user", "content": "yes or no?"}]})
        answer = g["choices"][0]["message"]["content"]
        if answer not in ("yes", "no", "maybe"):
            raise AssertionError(f"grammar reply {answer!r}")
        launches = ragged_paged_attention.launches
        if launches <= 0:
            raise AssertionError("attention did not launch in phase text")
        torch.cuda.synchronize()
        prompts = [p for p, _ in seen]
        costs = text_host_costs(backend, prompts, grammar)
        bpe_ttft = text_ttft(port, TEXT_MODEL, eng)
        backend._to_request = orig
        del eng.submit
        return {
            "tokenizer": tok_info, "load_s": load_s,
            "warm_finish": warm["choices"][0]["finish_reason"],
            "requests": len(seen), "ragged_paged_attention_launches": launches,
            "burst": {n: {"ttft_ms": r["ttft_ms"], "chars": len(r["text"]),
                          "frames": len(r["frames"])}
                      for n, r in results.items()},
            "stream_vs_whole": pairs, "edit_chars": len(
                edit["choices"][0]["text"]),
            "tokenize_len": len(tok["tokens"]), "grammar_answer": answer,
            "host": costs,
            "ttft_same_request": {"bpe": bpe_ttft, "byte": byte_ttft},
            "card": smi, "phase_s": time.perf_counter() - t_phase,
        }
    finally:
        os.environ.pop("LOCALAI_PREFIX_CACHE", None)
        _shut(srv, th)


# ------------------------------------------------------------ phase 11

LC_KEY = "lc-key"  # the phase server's API key
LC_TAG = "chip-smoke-lifecycle"  # its Machine-Tag
LC_SLACK = 256 << 20  # allocated bytes an unload may leave above baseline
# an embedding through B1 against the same forward through the plain
# attention on the card: bf16 activations over 32 layers, held as the
# JAX harness holds a bf16 kernel (localai_tfp_tpu/ops/kernel_check.py)
EMB_TOL = JAX_TOL["bf16"]
LC_CHAT = {"max_tokens": 8, "messages": [
    {"role": "user", "content": "Name three colours."}]}
LC_TEXTS = ["The paged arena holds every slot's keys.",
            "An embedding is the mean of the final hidden states."]


def _req(port: int, method: str, path: str, body=None,
         headers: dict | None = None, timeout: float = 600.0):
    """(status, headers, body bytes) of one request, errors included."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path,
                  body=None if body is None else json.dumps(body).encode(),
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _mem() -> dict:
    import torch

    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "device_used": total - free}


def _count(family, **labels) -> float:
    return family.labels(**labels).snapshot()["value"]


def _unloaded(backend, limit: float = 60.0) -> dict:
    """Wait for ``backend``'s shutdown (a watchdog's or the loader's, on
    another thread) to finish; its unload_stats."""
    t0 = time.perf_counter()
    while backend.unload_stats is None:
        if time.perf_counter() - t0 > limit:
            raise AssertionError("the backend was not unloaded in "
                                 f"{limit} s")
        time.sleep(0.05)
    return backend.unload_stats


def _back(what: str, allocated: int, base: dict) -> int:
    """Allocated bytes above the baseline after an unload; raises past
    LC_SLACK."""
    residue = allocated - base["allocated"]
    if residue > LC_SLACK:
        raise AssertionError(f"{what}: {residue} allocated bytes above the "
                             f"pre-load baseline (limit {LC_SLACK})")
    return residue


def killed_stream(port: int, body: dict, headers: dict) -> dict:
    """A streamed chat read until the server ends it: its frames, the
    last finish_reason, whether [DONE] came, and the seconds taken."""
    import http.client

    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    frames, finish, done, closed = 0, None, False, False
    try:
        c.request("POST", "/v1/chat/completions",
                  body=json.dumps(body).encode(),
                  headers={"Content-Type": "application/json", **headers})
        r = c.getresponse()
        if r.status != 200:
            raise AssertionError(f"busy stream: HTTP {r.status}")
        while True:
            try:
                line = r.readline()
            except (ConnectionError, http.client.IncompleteRead):
                closed = True
                break
            if not line:
                closed = True
                break
            line = line.strip()
            if line == b"data: [DONE]":
                done = True
            elif line.startswith(b"data: "):
                frames += 1
                obj = json.loads(line[6:])
                finish = obj["choices"][0].get("finish_reason") or finish
    finally:
        c.close()
    return {"frames": frames, "finish_reason": finish, "done": done,
            "closed": closed, "s": round(time.perf_counter() - t0, 3)}


def phase_lifecycle(ckpt_name: str, layers: int, smi: str) -> dict:
    """The server shell on the card: one server built from an
    ApplicationConfig (an API key, single-active backend, a Machine-Tag,
    both watchdogs on at 0.5 s ticks) over three configs on phase 5's
    checkpoint — lc-bf16 (embeddings on), lc-int8 (int8 weights from the
    artifact phase 5 wrote) and lc-bare (a directory with no YAML)."""
    import gc
    import shutil
    import threading

    import torch

    from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
    from localai_tfp_tpu_torch.models import transformer as tt
    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_attention_plain, ragged_paged_attention,
    )
    from localai_tfp_tpu_torch.server.app import Server
    from localai_tfp_tpu_torch.server.state import Application
    from localai_tfp_tpu_torch.telemetry import metrics as tm

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke"
    models = root / "lifecycle"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    for name in ("lc-ckpt", "lc-bare"):
        (models / name).symlink_to(root / "models" / ckpt_name,
                                   target_is_directory=True)
    # two slots: the phase is about the lifecycle, so each load captures
    # few graph variants
    base_cfg = {"backend": "torch-llm", "context_size": CONTEXT,
                "max_batch_slots": 2, "dtype": "bfloat16",
                "parameters": {"model": "lc-ckpt", "temperature": 0.0},
                "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                             "chat": "{{.Input}}\nassistant:"}}
    for name, extra in (("lc-bf16", {"embeddings": True}),
                        ("lc-int8", {"quantization": "int8"})):
        (models / f"{name}.yaml").write_text(json.dumps(
            {**base_cfg, "name": name, **extra}, indent=1))
    os.environ.setdefault("LOCALAI_QUANT_CACHE_DIR", str(root / "quant"))
    os.environ["LOCALAI_QUANT_ARTIFACTS"] = "on"
    app = Application(ApplicationConfig(
        models_path=str(models), config_dir=str(models / "configuration"),
        state_dir=str(models / "run"), address="127.0.0.1", port=0,
        api_keys=[LC_KEY], single_active_backend=True, machine_tag=LC_TAG,
        enable_watchdog_busy=True, enable_watchdog_idle=True,
        watchdog_busy_timeout=3600.0, watchdog_idle_timeout=3600.0),
        device="cuda")
    app.watchdog.interval = 0.5
    wd = app.watchdog
    gc.collect()
    torch.cuda.empty_cache()
    base = _mem()
    srv = Server(app)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    auth = {"Authorization": f"Bearer {LC_KEY}"}
    out: dict = {"baseline": base}

    def chat(model: str, **kw):
        st, hd, raw = _req(port, "POST", "/v1/chat/completions",
                           {**LC_CHAT, "model": model, **kw}, auth)
        if st != 200:
            raise AssertionError(f"chat to {model}: HTTP {st} {raw[:200]!r}")
        return json.loads(raw)

    try:
        # (a) auth and the response headers
        st, _, _ = _req(port, "POST", "/v1/chat/completions",
                        {**LC_CHAT, "model": "lc-bf16"})
        open_ = {p: _req(port, "GET", p)[0]
                 for p in ("/healthz", "/readyz", "/metrics", "/version")}
        st_k, hd, _ = _req(port, "GET", "/v1/models", headers={
            **auth, "X-Correlation-ID": "lc-corr-1"})
        if st != 401 or set(open_.values()) != {200} or st_k != 200:
            raise AssertionError(f"auth: chat without a key {st}, "
                                 f"exempt {open_}, keyed {st_k}")
        if (hd.get("Machine-Tag"), hd.get("X-Correlation-ID")) != (
                LC_TAG, "lc-corr-1"):
            raise AssertionError(f"response headers {hd}")
        out["auth"] = {"unkeyed_chat": st, "exempt": open_}
        log("lifecycle_auth", **out["auth"], card=smi)

        # (b) two concurrent first requests: one load
        loads0 = _count(tm.MODEL_LOADS, model="lc-bf16", result="success")
        replies: list = [None, None]

        def first(i):
            replies[i] = chat("lc-bf16")

        t0 = time.perf_counter()
        ts = [threading.Thread(target=first, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        wall = time.perf_counter() - t0
        loads = _count(tm.MODEL_LOADS, model="lc-bf16",
                       result="success") - loads0
        texts = [r["choices"][0]["message"]["content"] for r in replies]
        if loads != 1 or texts[0] != texts[1]:
            raise AssertionError(f"coalescing: {loads} loads, texts {texts}")
        bf16 = app.loaded()["lc-bf16"]
        loaded_bf16 = _mem()
        out["coalesce"] = {"loads": loads, "wall_s": round(wall, 3),
                           "load_s": round(bf16.load_s, 3),
                           "load_mode": bf16.load_mode,
                           "warmup_s": bf16.load_breakdown["warmup_s"],
                           "memory": loaded_bf16}
        log("lifecycle_coalesce", **out["coalesce"], card=smi)

        # (c) embeddings through B1, against the plain attention
        n0 = ragged_paged_attention.launches
        inputs = [LC_TEXTS[0], LC_TEXTS[1], LC_TEXTS[0]]
        t0 = time.perf_counter()
        st, _, raw = _req(port, "POST", "/v1/embeddings",
                          {"model": "lc-bf16", "input": inputs}, auth)
        emb_s = time.perf_counter() - t0
        launched = ragged_paged_attention.launches - n0
        if st != 200:
            raise AssertionError(f"embeddings: HTTP {st} {raw[:200]!r}")
        body = json.loads(raw)
        vecs = [torch.tensor(d["embedding"]) for d in body["data"]]
        if [v.shape for v in vecs] != [(GEOMETRY["hidden_size"],)] * 3 or \
                not all(bool(torch.isfinite(v).all()) for v in vecs):
            raise AssertionError("embeddings: shape or non-finite values")
        if not torch.equal(vecs[0], vecs[2]):
            raise AssertionError("embeddings: one input, two vectors")
        if launched != layers * len(inputs):
            raise AssertionError(f"embeddings: B1 launched {launched} times "
                                 f"for {len(inputs)} forwards of {layers} "
                                 "layers")
        eng = bf16.engine
        tt.ragged_paged_attention = ragged_attention_plain
        try:
            want = eng.embed(LC_TEXTS[0])
        finally:
            tt.ragged_paged_attention = ragged_paged_attention
        del eng
        err = float((vecs[0] - want).abs().max())
        bound = EMB_TOL * max(1.0, float(want.abs().max()))
        if err > bound:
            raise AssertionError(f"embedding through B1 is {err} from the "
                                 f"plain attention's (bound {bound})")
        out["embeddings"] = {"b1_launches": launched,
                             "per_forward": launched // len(inputs),
                             "max_abs_err": err, "tol": bound,
                             "tol_rule": f"{EMB_TOL} x max(1, max|plain|)",
                             "request_s": round(emb_s, 3)}
        log("lifecycle_embeddings", **out["embeddings"], card=smi)

        # (d) the single-active swap to the int8 model
        ev0 = _count(tm.MODEL_EVICTIONS, reason="single_active")
        b2_0 = int8_matmul.launches
        chat("lc-int8")
        evicted = _count(tm.MODEL_EVICTIONS, reason="single_active") - ev0
        stats = bf16.unload_stats
        del bf16
        int8 = app.loaded()["lc-int8"]
        loaded_int8 = _mem()
        st, _, raw = _req(port, "GET", "/system", headers=auth)
        system = json.loads(raw)
        smi_used = torch.cuda.mem_get_info()
        row = system["device_memory"][0]
        if evicted != 1 or system["loaded_models"] != ["lc-int8"]:
            raise AssertionError(f"swap: {evicted} evictions, loaded "
                                 f"{system['loaded_models']}")
        drift = abs(row["bytes_in_use"] - (smi_used[1] - smi_used[0]))
        if row["bytes_limit"] != smi_used[1] or drift > 64 << 20:
            raise AssertionError(f"/system device_memory {row} against "
                                 f"mem_get_info {smi_used}")
        out["swap"] = {
            "evictions": evicted, "unload": stats,
            "residue_before_int8_load": _back(
                "single-active eviction", stats["allocated_after_gc"], base),
            "int8_load_mode": int8.load_mode,
            "int8_load_s": round(int8.load_s, 3),
            "b2_launches": int8_matmul.launches - b2_0,
            "memory_int8": loaded_int8,
            "system_device_memory": row, "system_drift_bytes": drift}
        log("lifecycle_swap", **out["swap"], card=smi)

        # (e) monitor and shutdown
        st, _, raw = _req(port, "GET", "/backend/monitor?model=lc-int8",
                          headers=auth)
        st404, _, _ = _req(port, "GET", "/backend/monitor?model=nowhere",
                           headers=auth)
        mon = json.loads(raw)
        if st != 200 or mon["status"] != "READY" or st404 != 404:
            raise AssertionError(f"monitor: {st} {mon.get('status')}, "
                                 f"unknown {st404}")
        t0 = time.perf_counter()
        st, _, _ = _req(port, "POST", "/backend/shutdown",
                        {"model": "lc-int8"}, auth)
        shut_s = time.perf_counter() - t0
        if st != 200:
            raise AssertionError(f"/backend/shutdown: HTTP {st}")
        del int8
        after = _mem()
        out["shutdown"] = {"monitor_state": mon["status"],
                           "monitor_memory": mon["memory_info"],
                           "shutdown_s": round(shut_s, 3), "memory": after,
                           "residue": _back("/backend/shutdown",
                                            after["allocated"], base)}
        log("lifecycle_shutdown", **out["shutdown"], card=smi)

        # (f) the busy watchdog kills a long stream; the next request
        # reloads; then the idle watchdog unloads
        chat("lc-bf16")
        victim = app.loaded()["lc-bf16"]
        kills0 = _count(tm.WATCHDOG_KILLS, kind="busy")
        wd.busy_timeout = 3.0
        try:
            stream = killed_stream(port, {
                "model": "lc-bf16", "stream": True, "max_tokens": 2048,
                "ignore_eos": True,
                "messages": [{"role": "user", "content": "Count on."}]},
                auth)
            stats = _unloaded(victim)
        finally:
            wd.busy_timeout = 3600.0
        del victim
        kills = _count(tm.WATCHDOG_KILLS, kind="busy") - kills0
        if kills != 1 or not (stream["finish_reason"] == "error"
                              or stream["closed"]):
            raise AssertionError(f"busy kill: {kills} kills, stream {stream}")
        torch.cuda.synchronize()  # a CUDA error from the kill raises here
        loads0 = _count(tm.MODEL_LOADS, model="lc-bf16", result="success")
        reply = chat("lc-bf16")
        reloads = _count(tm.MODEL_LOADS, model="lc-bf16",
                         result="success") - loads0
        out["busy"] = {"stream": stream, "kills": kills, "unload": stats,
                       "residue": _back("busy kill",
                                        stats["allocated_after_gc"], base),
                       "reloads": reloads, "next_finish": reply["choices"][0][
                           "finish_reason"]}
        log("lifecycle_busy", **out["busy"], card=smi)
        idle_victim = app.loaded()["lc-bf16"]
        kills0 = _count(tm.WATCHDOG_KILLS, kind="idle")
        t0 = time.perf_counter()
        wd.idle_timeout = 2.0
        try:
            stats = _unloaded(idle_victim)
        finally:
            wd.idle_timeout = 3600.0
        del idle_victim
        kills = _count(tm.WATCHDOG_KILLS, kind="idle") - kills0
        if kills != 1 or app.model_loader.loaded_names():
            raise AssertionError(f"idle kill: {kills} kills, loaded "
                                 f"{app.model_loader.loaded_names()}")
        out["idle"] = {"kills": kills, "unload": stats,
                       "after_s": round(time.perf_counter() - t0, 3),
                       "residue": _back("idle kill",
                                        stats["allocated_after_gc"], base)}
        log("lifecycle_idle", **out["idle"], card=smi)

        # (g) a bare model directory with no YAML
        bare = chat("lc-bare")
        out["bare"] = {"finish_reason": bare["choices"][0]["finish_reason"],
                       "completion_tokens": bare["usage"][
                           "completion_tokens"]}
        log("lifecycle_bare", **out["bare"], card=smi)
    finally:
        srv.close()
        th.join(timeout=30)
    # what the process still holds once every model is gone: B1's merge
    # counters and cuBLAS's workspaces (one per handle and stream), the
    # latter measured by clearing them
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import _counters

    held = _mem()
    counters = sum(t.numel() * t.element_size() for t in _counters.values())
    cleared = None
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
        cleared = held["allocated"] - _mem()["allocated"]
    out["held_after_all_unloads"] = {
        "allocated": held["allocated"], "above_baseline": _back(
            "server close", held["allocated"], base),
        "b1_merge_counters": counters, "cublas_workspaces": cleared,
        "other": held["allocated"] - counters - (cleared or 0)}
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("lifecycle_held", **out["held_after_all_unloads"],
        phase_s=out["phase_s"], card=smi)
    return out


# ------------------------------------------------------------ phase 12

# the text tower of Google's gemma-3-4b-it config.json (text_config)
GEMMA3_4B = {
    "model_type": "gemma3_text", "hidden_size": 2560,
    "intermediate_size": 10240, "num_attention_heads": 8,
    "num_key_value_heads": 4, "head_dim": 256, "num_hidden_layers": 34,
    "vocab_size": 262208, "sliding_window": 1024,
    "sliding_window_pattern": 6, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0,
    "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-6,
    "hidden_activation": "gelu_pytorch_tanh",
    "max_position_embeddings": 131072,
}
# Google's gemma-2-2b-it config.json
GEMMA2_2B = {
    "model_type": "gemma2", "hidden_size": 2304, "intermediate_size": 9216,
    "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 256,
    "num_hidden_layers": 26, "vocab_size": 256000, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "hidden_activation": "gelu_pytorch_tanh",
    "max_position_embeddings": 8192,
}
# Microsoft's Phi-3-mini-4k-instruct config.json
PHI3_MINI = {
    "model_type": "phi3", "hidden_size": 3072, "intermediate_size": 8192,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "num_hidden_layers": 32, "vocab_size": 32064, "sliding_window": 2047,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "hidden_act": "silu",
    "max_position_embeddings": 4096, "tie_word_embeddings": False,
}
PHI3_LAYERS = 8  # a depth cut: Phi-3-mini has 32
FAMILY_CONTEXT = 4096
# LocalAI's gallery template for Gemma, as Go templates
GEMMA_TEMPLATE = {
    "chat_message": '<start_of_turn>{{if eq .RoleName "assistant" }}model'
                    '{{else}}{{ .RoleName }}{{end}}\n{{ if .Content -}}'
                    '{{.Content -}}{{ end -}}<end_of_turn>',
    "chat": "{{.Input }}\n<start_of_turn>model\n",
}
# a prompt over 1100 tokens (the byte tokenizer: one token a byte), so
# Gemma 3's sliding layers (window 1024) and global layers see different
# keys from the first decode step on, past position 1024 + 64
LONG_PROMPT = ("The sliding layers see the last 1024 tokens; the global "
               "layers see them all. ") * 15


def family_layout(g: dict, layers: int, prefix: str) -> list:
    """(name, HF [out, in] shape) of every tensor of a checkpoint of
    geometry ``g``: Gemma 2/3 with their sandwich norms (Gemma 3 with
    q/k norms), Phi-3 with fused qkv_proj and gate_up_proj, and the
    Qwen mixtures of experts (a router and per-expert projections;
    Qwen2-MoE's q/k/v biases and sigmoid-gated shared expert, Qwen3-MoE's
    q/k norms)."""
    D, F, V = g["hidden_size"], g["intermediate_size"], g["vocab_size"]
    dh = g.get("head_dim") or D // g["num_attention_heads"]
    q, kv = g["num_attention_heads"] * dh, g["num_key_value_heads"] * dh
    mt = g["model_type"]
    out = [(f"{prefix}embed_tokens.weight", (V, D)),
           (f"{prefix}norm.weight", (D,))]
    if mt in ("phi3", "qwen2_moe", "qwen3_moe"):
        out.append(("lm_head.weight", (V, D)))
    if mt in ("qwen2_moe", "qwen3_moe"):
        E, Fm = g["num_experts"], g["moe_intermediate_size"]
        for i in range(layers):
            lp = f"{prefix}layers.{i}."
            out += [(lp + "self_attn.q_proj.weight", (q, D)),
                    (lp + "self_attn.k_proj.weight", (kv, D)),
                    (lp + "self_attn.v_proj.weight", (kv, D)),
                    (lp + "self_attn.o_proj.weight", (D, q)),
                    (lp + "input_layernorm.weight", (D,)),
                    (lp + "post_attention_layernorm.weight", (D,)),
                    (lp + "mlp.gate.weight", (E, D))]
            if mt == "qwen2_moe":
                Fs = g["shared_expert_intermediate_size"]
                out += [(lp + "self_attn.q_proj.bias", (q,)),
                        (lp + "self_attn.k_proj.bias", (kv,)),
                        (lp + "self_attn.v_proj.bias", (kv,)),
                        (lp + "mlp.shared_expert.gate_proj.weight", (Fs, D)),
                        (lp + "mlp.shared_expert.up_proj.weight", (Fs, D)),
                        (lp + "mlp.shared_expert.down_proj.weight", (D, Fs)),
                        (lp + "mlp.shared_expert_gate.weight", (1, D))]
            else:
                out += [(lp + "self_attn.q_norm.weight", (dh,)),
                        (lp + "self_attn.k_norm.weight", (dh,))]
            for e in range(E):
                ep = lp + f"mlp.experts.{e}."
                out += [(ep + "gate_proj.weight", (Fm, D)),
                        (ep + "up_proj.weight", (Fm, D)),
                        (ep + "down_proj.weight", (D, Fm))]
        return out
    for i in range(layers):
        lp = f"{prefix}layers.{i}."
        if mt == "phi3":
            out += [(lp + "self_attn.qkv_proj.weight", (q + 2 * kv, D)),
                    (lp + "mlp.gate_up_proj.weight", (2 * F, D))]
        else:
            out += [(lp + "self_attn.q_proj.weight", (q, D)),
                    (lp + "self_attn.k_proj.weight", (kv, D)),
                    (lp + "self_attn.v_proj.weight", (kv, D)),
                    (lp + "mlp.gate_proj.weight", (F, D)),
                    (lp + "mlp.up_proj.weight", (F, D))]
        out += [(lp + "self_attn.o_proj.weight", (D, q)),
                (lp + "mlp.down_proj.weight", (D, F)),
                (lp + "input_layernorm.weight", (D,)),
                (lp + "post_attention_layernorm.weight", (D,))]
        if mt != "phi3":
            out += [(lp + "pre_feedforward_layernorm.weight", (D,)),
                    (lp + "post_feedforward_layernorm.weight", (D,))]
        if mt == "gemma3_text":
            out += [(lp + "self_attn.q_norm.weight", (dh,)),
                    (lp + "self_attn.k_norm.weight", (dh,))]
    return out


def write_family_checkpoint(ckpt: Path, g: dict, layers: int, seed: int,
                            saturate: str = "last",
                            q_cap_scale: float = 4.0,
                            vision: dict | None = None) -> tuple[int, float]:
    """A checkpoint of geometry ``g`` with random bf16 weights made on the
    card from ``seed`` (matrices at 1/sqrt(fan-in); Gemma's norm weights
    0, which its ``1 + w`` norms read as 1; Phi-3's 1). Gemma ties its
    head to the embedding: at full scale each position's own embedding
    would outweigh what attention adds and the greedy ids would echo the
    input whatever attention computed, so its embedding is drawn at 1/20
    of that scale (the layers see it normalized). A model with an
    attention softcap has its last layer's q_proj scaled by 4x the cap
    and that layer's post-attention norm weight at 9 (a x10 scale): its
    logits (std ~1 otherwise) pass the cap, so the capped softmax is
    near uniform over the top positions where the uncapped one is one
    position, and that attention output dominates what the head reads.
    A kernel that drops the cap then serves other ids, while the bf16
    rounding of one saturated layer moves them little. ``saturate=
    "every"`` scales every layer's q_proj by ``q_cap_scale`` x the cap
    instead and no norm (phase ``softcap_witness``). Gemma 3 is
    written as the published multimodal checkpoint lays out its text
    tower: ``model_type: gemma3`` with a ``text_config``, tensors under
    ``language_model.model.``; with ``vision`` (a SigLIP
    ``vision_config`` and the image-token ids) its tower and projector
    too, drawn after the text tensors (so those are the same either
    way): LayerNorms 1 and 0, matrices at 1/sqrt(fan-in), the projector's
    ``(1 + w)`` norm 0. Returns (bytes, seconds)."""
    import math

    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    t0 = time.perf_counter()
    ckpt.mkdir(parents=True, exist_ok=True)
    mt = g["model_type"]
    prefix = "language_model.model." if mt == "gemma3_text" else "model."
    layout = family_layout(g, layers, prefix)
    if vision is not None:
        layout += siglip_layout(vision["vision_config"], g["hidden_size"])
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gemma = mt.startswith("gemma")
    norm = 0.0 if gemma else 1.0
    cap = g.get("attn_logit_softcapping")
    last = f"layers.{layers - 1}."

    def saturated(name: str, part: str) -> bool:
        return bool(cap) and part in name and (
            saturate == "every" or last + part in name)

    def tensors():
        for name, shape in layout:
            if name.startswith(("vision_tower.", "multi_modal_projector.")):
                yield name, tower_tensor(name, shape, gen, dev)
                continue
            if len(shape) == 1:
                w = 0.0 if name.endswith(".bias") else norm
                if saturate == "last" and saturated(
                        name, "post_attention_layernorm"):
                    w = 9.0
                yield name, torch.full(shape, w, dtype=torch.bfloat16,
                                       device=dev)
            else:
                w = torch.randn(shape, generator=gen, device=dev)
                scale = shape[1] ** -0.5
                if saturated(name, "self_attn.q_proj"):
                    scale *= q_cap_scale * cap
                if name.endswith("embed_tokens.weight") and gemma:
                    scale /= 20
                yield name, (w * scale).to(torch.bfloat16)

    shapes = [(n, torch.empty(s, dtype=torch.bfloat16, device="meta"))
              for n, s in layout]
    save_iter(tensors(), str(ckpt / "model.safetensors"), shapes=shapes)
    text = {**g, "num_hidden_layers": layers, "torch_dtype": "bfloat16"}
    config = ({"architectures": ["Gemma3ForConditionalGeneration"],
               "model_type": "gemma3", "text_config": text,
               "torch_dtype": "bfloat16", **(vision or {})}
              if mt == "gemma3_text" else text)
    (ckpt / "config.json").write_text(json.dumps(config, indent=1))
    nbytes = sum(2 * math.prod(s) for _, s in layout)
    return nbytes, time.perf_counter() - t0


def family_yaml(models: Path, name: str, ckpt: str, **extra) -> None:
    (models / f"{name}.yaml").write_text(json.dumps({
        "name": name, "backend": "torch-llm",
        "parameters": {"model": ckpt, "temperature": 0.0, "max_tokens": 32},
        "context_size": FAMILY_CONTEXT, "max_batch_slots": SLOTS,
        "dtype": "bfloat16", "stopwords": ["<end_of_turn>"],
        "template": GEMMA_TEMPLATE, **extra}, indent=1))


def family_burst(port: int, model: str, eng, bodies: list,
                 by_m: dict | None = None) -> dict:
    """``bodies`` streamed at once; each stream's frames, usage and host
    ms to its first token; the kernels' counts (and ``by_m``, B2's calls
    by M) set to 0 just before and read just after; the engine's
    forwards, replays and host ms per decode forward (the step ends in
    the host read of its tokens)."""
    import threading

    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    results, errors = {}, []

    def send(i, body):
        body = {"model": model, "stream": True, **body}
        try:
            r = stream_post(port, "/v1/chat/completions", body,
                            {"Extra-Usage": "1"})  # the timings in usage
            last = r["frames"][-1]
            usage, finish = last["usage"], last["choices"][0]["finish_reason"]
            n = usage["completion_tokens"]
            if not (n > 0 and ((finish == "length" and n == body["max_tokens"])
                               or (finish == "stop"
                                   and n <= body["max_tokens"]))):
                raise AssertionError(f"finish {finish!r} usage {usage}")
            # the engine's submit-to-first-token ms: a random model's
            # tokens are mostly ids past the byte tokenizer's 256, which
            # decode to no text, so the first text frame can come late
            results[i] = {"prompt_tokens": usage["prompt_tokens"],
                          "completion_tokens": n, "finish_reason": finish,
                          "first_token_ms": usage["timing_first_token"],
                          "first_text_ms": r["ttft_ms"]}
        except Exception as e:  # re-raised below
            errors.append(f"{i}: {e!r}")

    spent = [0.0]
    step = eng._decode_step

    def clocked(*a, **kw):
        t = time.perf_counter()
        try:
            return step(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t

    eng._decode_step = clocked
    m = eng.metrics
    before = (m.forward_steps, m.decode_steps, m.mixed_steps,
              m.graph_replays, m.mixed_replays)
    torch.cuda.synchronize()
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    if by_m is not None:
        by_m.clear()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i, b))
               for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "int8_matmul": int8_matmul.launches}
    calls_by_m = dict(sorted(by_m.items())) if by_m is not None else None
    del eng._decode_step
    if errors or len(results) != len(bodies):
        raise AssertionError(f"{model}: requests failed: {errors}")
    steps, decode, mixed, replays, mreplays = (
        a - b for a, b in zip((m.forward_steps, m.decode_steps,
                               m.mixed_steps, m.graph_replays,
                               m.mixed_replays), before))
    return {"requests": [results[i] for i in range(len(bodies))],
            "wall_s": round(wall, 3), "forward_steps": steps,
            "decode_forwards": decode, "mixed_forwards": mixed,
            "decode_replays": replays, "mixed_replays": mreplays,
            "ms_per_decode_forward": round(spent[0] * 1e3 / max(1, decode),
                                           3),
            "launches": launches,
            **({"int8_matmul_calls_by_m": calls_by_m} if by_m is not None
               else {})}


def served_greedy(backend, text: str, max_tokens: int) -> tuple:
    """(prompt ids, generated ids) of one greedy request of ``text``, with
    the template's turns, straight to the engine."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    eng = backend.engine
    prompt = backend.tokenizer.encode(
        f"<start_of_turn>user\n{text}<end_of_turn>\n<start_of_turn>model\n",
        add_bos=True)
    got = {}
    orig = eng._finish

    def spy(slot, reason):
        got["ids"] = list(slot.generated)
        return orig(slot, reason)

    eng._finish = spy
    try:
        ev = eng.generate(GenRequest(prompt_ids=prompt, max_tokens=max_tokens,
                                     ignore_eos=True))
    finally:
        del eng._finish
    if ev.error:
        raise AssertionError(f"reference request failed: {ev.error}")
    return prompt, got["ids"]


def reference_engine(eng, dtype=None, **spec_changes):
    """What ``dense_deficits`` reads of ``eng``, with its int8 projections
    dequantized (the reference forward then runs no B2, so a B2 fault
    cannot sit on both sides of the check), the weights cast to
    ``dtype`` when given, and ``spec_changes`` made to the spec."""
    import dataclasses
    import types

    import torch

    from localai_tfp_tpu_torch.models.quant import QTensor, dequantize

    params = {}
    for k, v in eng.params.items():
        w = (dequantize(v).to(torch.bfloat16) if isinstance(v, QTensor)
             else v)
        params[k] = w.to(dtype) if dtype is not None else w
    return types.SimpleNamespace(
        spec=dataclasses.replace(eng.spec, **spec_changes), params=params,
        device=eng.device, sampling=eng.sampling)


def family_reference(backend, text: str, max_tokens: int) -> dict:
    """One greedy request of ``text``; its ids held to the argmax of the
    plain dense forward (``_attend``, with each layer's window and the
    softcap; int8 projections dequantized) over the same tokens, as
    ``reference_check`` holds the main path's. With a softcap, the same
    ids must fail the dense forward without it: the check sees a kernel
    that drops the cap."""
    eng = backend.engine
    prompt, ids = served_greedy(backend, text, max_tokens)
    if eng.spec.n_experts:
        ref = moe_deficits(reference_engine(eng), prompt, ids)
    else:
        ref = dense_deficits(reference_engine(eng), prompt, ids)
    ref["prompt_tokens"] = len(prompt)
    if not ref["worst_logit_deficit"] <= ref["tol"]:
        raise AssertionError(f"greedy ids are not the dense reference's "
                             f"argmax: {ref}")
    if eng.spec.attn_logit_softcap:
        uncapped = reference_engine(eng, attn_logit_softcap=0.0)
        ref["uncapped"] = dense_deficits(uncapped, prompt, ids)
        if not ref["uncapped"]["worst_logit_deficit"] > \
                ref["uncapped"]["tol"]:
            raise AssertionError(f"the served ids also pass the dense "
                                 f"forward without the softcap: {ref}")
    return ref


def serve_family(models: Path, model: str, smi: str, bodies: list,
                 ref_text: str, layers: int, graphs_every_decode: bool,
                 int8: bool = False, profile: bool = False,
                 tag: str = "families", on_load=None, after=None) -> dict:
    """Load ``model`` through the port's server, stream ``bodies`` (or
    ``bodies(backend)``) at once
    (B1 once per layer of every forward; B2 on an int8 config), hold a
    greedy request to the dense reference, (``profile``) profile 8
    decoding requests as phase main does, and unload. Lines are logged
    as ``<tag>_*``; ``on_load(backend)`` runs before the burst and
    ``after(backend, result)`` after the reference, while the model is
    loaded (their dicts land in the result as ``on_load`` / ``after``)."""
    import torch

    from localai_tfp_tpu_torch.models.transformer import layer_windows

    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        t0 = time.perf_counter()
        backend = _loaded(port, srv.app, model)
        eng = backend.engine
        load = {"load_s": round(backend.load_s, 3), "mode": backend.load_mode,
                "load_and_first_request_s": round(time.perf_counter() - t0, 3),
                "warmup_s": round(eng.metrics.warmup_s, 3),
                "variants": eng.variant_count(),
                "param_bytes": param_bytes(eng.params),
                "kv_arena_bytes": eng.cache.nbytes(),
                "windows": sorted(set(layer_windows(eng.spec))),
                "softcap": eng.spec.attn_logit_softcap,
                "graph_pool_bytes": eng._graph_pool_bytes}
        log(f"{tag}_load", model=model, card=smi, **load)
        hooked = on_load(backend) if on_load is not None else None
        if callable(bodies):  # made from the loaded model (its tokenizer)
            bodies = bodies(backend)
        by_m = undo = None
        if int8:
            by_m, undo = _b2_by_m(eng)
        try:
            burst = family_burst(port, model, eng, bodies, by_m)
        finally:
            if undo is not None:
                undo()
        got = burst["launches"]
        if got["ragged_paged_attention"] != layers * burst["forward_steps"]:
            raise AssertionError(
                f"{model}: B1 launched {got['ragged_paged_attention']} times "
                f"for {burst['forward_steps']} forwards of {layers} layers")
        if graphs_every_decode and (
                burst["decode_replays"] != burst["decode_forwards"]
                or burst["mixed_replays"] != burst["mixed_forwards"]):
            raise AssertionError(f"{model}: forwards not all replays: "
                                 f"{burst}")
        if int8:
            by_m = burst["int8_matmul_calls_by_m"]  # read with the counts
            if not got["int8_matmul"] or not by_m:
                raise AssertionError(f"{model}: int8_matmul never launched")
            if got["int8_matmul"] != sum(by_m.values()):
                raise AssertionError(
                    f"{model}: int8_matmul launched {got['int8_matmul']} "
                    f"times for {sum(by_m.values())} calls by M {by_m}")
        log(f"{tag}_burst", model=model, card=smi, **burst)
        ref = family_reference(backend, ref_text, 16)
        log(f"{tag}_reference", model=model, card=smi, **ref)
        prof = None
        if profile:
            prof = profile_decode(eng)
            log(f"{tag}_profile", model=model, card=smi, **prof)
        eng.leak_check()
        res = {"load": load, "burst": burst, "reference": ref,
               "profile": prof, "on_load": hooked, "port": port}
        if after is not None:
            res["after"] = after(backend, res)
        return res
    finally:
        _shut(srv, th)
        torch.cuda.empty_cache()


def family_chats() -> list:
    """Phase families' four chats: the long one (past the 1024 window),
    two short greedy ones and a sampled one."""
    return [
        {"max_tokens": 48, "messages": [{"role": "user",
                                         "content": LONG_PROMPT}]},
        {"max_tokens": 32, "messages": [{"role": "user",
                                         "content": "Say hello."}]},
        {"max_tokens": 24, "messages": [
            {"role": "user", "content": "Name three colours."},
            {"role": "assistant", "content": "Red, green, blue."},
            {"role": "user", "content": "And three more?"}]},
        {"max_tokens": 16, "temperature": 0.8, "seed": 7, "top_k": 40,
         "messages": [{"role": "user", "content": "Pick a word."}]},
    ]


def phase_families(smi: str, seed: int) -> dict:
    """(a) Gemma-3-4B-it at full width and depth with its SigLIP tower
    (the multimodal checkpoint), bf16 then int8, each also serving the
    image chats (``image_leg``); (b) Gemma-2-2B-it at full width and
    depth; (c) Phi-3-mini-4k at full width, 8 layers."""
    import shutil

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "family_models"
    models.mkdir(parents=True, exist_ok=True)
    out = {}
    chats = family_chats()
    saved = os.environ.get("LOCALAI_QUANT_ARTIFACTS")
    for key, g, layers, cut in (
            ("gemma3_4b", GEMMA3_4B, GEMMA3_4B["num_hidden_layers"], None),
            ("gemma2_2b", GEMMA2_2B, GEMMA2_2B["num_hidden_layers"], None),
            ("phi3_mini", PHI3_MINI, PHI3_LAYERS,
             f"layers {PHI3_LAYERS} of {PHI3_MINI['num_hidden_layers']}")):
        ckpt = f"{key}-L{layers}-s{seed}"
        nbytes, write_s = write_family_checkpoint(
            models / ckpt, g, layers, seed,
            vision=GEMMA3_VISION if key == "gemma3_4b" else None)
        log("families_checkpoint", model=key, bytes=nbytes,
            write_s=round(write_s, 3), layers=layers, reduced=cut, card=smi)
        family_yaml(models, key, ckpt)
        if key == "gemma3_4b":
            res = serve_family(
                models, key, smi, chats, LONG_PROMPT, layers, True,
                profile=True, after=lambda b, r: image_leg(
                    b, r, key, layers, smi, "families", itl=True))
            ctx = max(r["prompt_tokens"] + r["completion_tokens"]
                      for r in res["burst"]["requests"])
            if ctx <= g["sliding_window"] + 64:
                raise AssertionError(f"the long chat ends at {ctx}")
            # the same checkpoint quantized at load (no artifact: this
            # phase measures the serving, not the cache)
            family_yaml(models, f"{key}-int8", ckpt, quantization="int8")
            os.environ["LOCALAI_QUANT_ARTIFACTS"] = "off"
            try:
                res["int8"] = serve_family(
                    models, f"{key}-int8", smi, chats[1:2], "Say hello.",
                    layers, True, int8=True, after=lambda b, r: image_leg(
                        b, r, f"{key}-int8", layers, smi, "families_int8",
                        by_m=True))
            finally:
                if saved is None:
                    os.environ.pop("LOCALAI_QUANT_ARTIFACTS", None)
                else:
                    os.environ["LOCALAI_QUANT_ARTIFACTS"] = saved
        else:
            res = serve_family(models, key, smi, chats[1:3],
                               "Name three colours.", layers, True)
        res.update(layers=layers, reduced=cut, checkpoint_bytes=nbytes)
        out[key] = res
        shutil.rmtree(models / ckpt, ignore_errors=True)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("families", card=smi, phase_s=out["phase_s"],
        **{k: {"load_s": v["load"]["load_s"],
               "warmup_s": v["load"]["warmup_s"],
               "variants": v["load"]["variants"],
               "first_token_ms": [r["first_token_ms"]
                                  for r in v["burst"]["requests"]],
               "ms_per_decode_forward":
                   v["burst"]["ms_per_decode_forward"],
               "b1_launches_per_forward":
                   v["burst"]["launches"]["ragged_paged_attention"]
                   / max(1, v["burst"]["forward_steps"])}
           for k, v in out.items() if isinstance(v, dict)})
    return out


# ------------------------------------------------- images and recurrent


# google/gemma-3-4b-it config.json: the SigLIP tower and image tokens
SIGLIP_G3 = {
    "model_type": "siglip_vision_model", "hidden_size": 1152,
    "intermediate_size": 4304, "num_hidden_layers": 27,
    "num_attention_heads": 16, "image_size": 896, "patch_size": 14,
    "num_channels": 3, "layer_norm_eps": 1e-6,
}
GEMMA3_VISION = {"vision_config": SIGLIP_G3, "mm_tokens_per_image": 256,
                 "boi_token_index": 255999, "eoi_token_index": 256000,
                 "image_token_index": 262144}
# llava-hf/llava-1.5-7b-hf config.json: CLIP ViT-L/14-336 over Llama-2-7B
CLIP_L336 = {
    "model_type": "clip_vision_model", "hidden_size": 1024,
    "intermediate_size": 4096, "num_hidden_layers": 24,
    "num_attention_heads": 16, "image_size": 336, "patch_size": 14,
    "num_channels": 3, "layer_norm_eps": 1e-5, "projection_dim": 768,
}
LLAVA_TEXT = {
    "model_type": "llama", "hidden_size": 4096, "intermediate_size": 11008,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "num_hidden_layers": 32, "vocab_size": 32064, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "max_position_embeddings": 4096,
    "tie_word_embeddings": False,
}
LLAVA_LAYERS = 4  # a depth cut of the decoder: the tower runs at full depth
LLAVA_IMAGE_TOKEN = 32000
# state-spaces/mamba-2.8b-hf config.json
MAMBA_28B = {
    "model_type": "mamba", "hidden_size": 2560, "intermediate_size": 5120,
    "state_size": 16, "conv_kernel": 4, "time_step_rank": 160,
    "vocab_size": 50280, "num_hidden_layers": 64,
    "layer_norm_epsilon": 1e-5, "tie_word_embeddings": True,
}
MAMBA_LAYERS = 8  # a depth cut: 64 layers
# RWKV/rwkv-4-3b-pile config.json
RWKV4_3B = {
    "model_type": "rwkv", "hidden_size": 2560, "intermediate_size": 10240,
    "attention_hidden_size": 2560, "vocab_size": 50277,
    "num_hidden_layers": 32, "layer_norm_epsilon": 1e-5,
    "rescale_every": 6, "context_length": 1024,
}
RWKV_LAYERS = 8  # a depth cut: 32 layers
IMAGE_TEXT = "Describe the two pictures in one sentence."
IMAGE_TOKENS = 16  # greedy tokens of each image chat
RECURRENT_TOKENS = 128  # decode tokens timed by replay and eagerly
ITL_IMAGE_TOKENS = 256  # tokens of each text stream beside an image chat
RECURRENT_REPEATS = 3  # timed runs of each way, interleaved (the median kept)


def _encoder_layout(pref: str, c: dict) -> list:
    """(name, HF shape) of a SigLIP or CLIP encoder's layers."""
    D, F = c["hidden_size"], c["intermediate_size"]
    out = []
    for i in range(c["num_hidden_layers"]):
        lp = f"{pref}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(lp + f"self_attn.{n}.weight", (D, D)),
                    (lp + f"self_attn.{n}.bias", (D,))]
        out += [(lp + "layer_norm1.weight", (D,)),
                (lp + "layer_norm1.bias", (D,)),
                (lp + "layer_norm2.weight", (D,)),
                (lp + "layer_norm2.bias", (D,)),
                (lp + "mlp.fc1.weight", (F, D)), (lp + "mlp.fc1.bias", (F,)),
                (lp + "mlp.fc2.weight", (D, F)), (lp + "mlp.fc2.bias", (D,))]
    return out


def siglip_layout(c: dict, text_d: int) -> list:
    """Gemma 3's SigLIP tower and projector, as HF saves them."""
    pref = "vision_tower.vision_model."
    D, P = c["hidden_size"], c["patch_size"]
    n = (c["image_size"] // P) ** 2
    return ([(pref + "embeddings.patch_embedding.weight",
              (D, c["num_channels"], P, P)),
             (pref + "embeddings.patch_embedding.bias", (D,)),
             (pref + "embeddings.position_embedding.weight", (n, D))]
            + _encoder_layout(pref, c)
            + [(pref + "post_layernorm.weight", (D,)),
               (pref + "post_layernorm.bias", (D,)),
               ("multi_modal_projector.mm_input_projection_weight",
                (D, text_d)),
               ("multi_modal_projector.mm_soft_emb_norm.weight", (D,))])


def clip_layout(c: dict, text_d: int) -> list:
    """LLaVA's CLIP tower (``pre_layrnorm``, HF's spelling) and MLP
    projector."""
    pref = "vision_tower.vision_model."
    D, P = c["hidden_size"], c["patch_size"]
    n = (c["image_size"] // P) ** 2 + 1
    return ([(pref + "embeddings.class_embedding", (D,)),
             (pref + "embeddings.patch_embedding.weight",
              (D, c["num_channels"], P, P)),
             (pref + "embeddings.position_embedding.weight", (n, D)),
             (pref + "pre_layrnorm.weight", (D,)),
             (pref + "pre_layrnorm.bias", (D,))]
            + _encoder_layout(pref, c)
            + [(pref + "post_layernorm.weight", (D,)),
               (pref + "post_layernorm.bias", (D,)),
               ("multi_modal_projector.linear_1.weight", (text_d, D)),
               ("multi_modal_projector.linear_1.bias", (text_d,)),
               ("multi_modal_projector.linear_2.weight", (text_d, text_d)),
               ("multi_modal_projector.linear_2.bias", (text_d,))])


SOFT_SCALE = 1 / 20  # the projector's last matrix, as the text embedding


def tower_tensor(name: str, shape: tuple, gen, dev):
    """A tower or projector tensor: biases 0, LayerNorm weights 1 (the
    Gemma projector's ``(1 + w)`` norm 0), the CLS embedding at unit
    scale, matrices at 1/sqrt(fan-in); the projector's last matrix at
    SOFT_SCALE of that, so soft rows are of the text rows' size (the
    random text embeddings are drawn small: see
    ``write_family_checkpoint``); bf16 on ``dev``."""
    import math

    import torch

    if len(shape) == 1 and not name.endswith("class_embedding"):
        w = 0.0 if name.endswith(".bias") or "mm_soft_emb_norm" in name \
            else 1.0
        return torch.full(shape, w, dtype=torch.bfloat16, device=dev)
    fan_in = (shape[0] if name.endswith("mm_input_projection_weight")
              else math.prod(shape[1:]) or 1)
    if name.endswith(("mm_input_projection_weight", "linear_2.weight")):
        fan_in /= SOFT_SCALE ** 2
    w = torch.randn(shape, generator=gen, device=dev)
    return (w * fan_in ** -0.5).to(torch.bfloat16)


def write_tensors(ckpt: Path, layout: list, config: dict, make) -> tuple:
    """``config.json`` and one ``model.safetensors`` of ``layout``'s
    tensors, each made on the card by ``make(name, shape)`` as it is
    written. Returns (bytes, seconds)."""
    import math

    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    t0 = time.perf_counter()
    ckpt.mkdir(parents=True, exist_ok=True)
    shapes = [(n, torch.empty(s, dtype=torch.bfloat16, device="meta"))
              for n, s in layout]
    save_iter(((n, make(n, s)) for n, s in layout),
              str(ckpt / "model.safetensors"), shapes=shapes)
    (ckpt / "config.json").write_text(json.dumps(config, indent=1))
    return (sum(2 * math.prod(s) for _, s in layout),
            round(time.perf_counter() - t0, 3))


def write_llava(ckpt: Path, seed: int) -> tuple:
    """LLaVA-1.5-7B: the CLIP tower at full depth, the Llama-2-7B decoder
    at full width and LLAVA_LAYERS layers (HF's older layout: the text
    model under ``language_model.``)."""
    import torch

    g = {**LLAVA_TEXT, "num_hidden_layers": LLAVA_LAYERS}
    D = g["hidden_size"]
    text = [(n, s) for n, s in family_layout(
        {**g, "model_type": "llama"}, LLAVA_LAYERS, "language_model.model.")
        if "feedforward_layernorm" not in n]
    layout = (text + [("language_model.lm_head.weight",
                       (g["vocab_size"], D))] + clip_layout(CLIP_L336, D))
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(name, shape):
        if name.startswith(("vision_tower.", "multi_modal_projector.")):
            return tower_tensor(name, shape, gen, dev)
        if len(shape) == 1:
            return torch.ones(shape, dtype=torch.bfloat16, device=dev)
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * shape[1] ** -0.5).to(torch.bfloat16)

    config = {"architectures": ["LlavaForConditionalGeneration"],
              "model_type": "llava", "text_config": g,
              "vision_config": CLIP_L336,
              "image_token_index": LLAVA_IMAGE_TOKEN,
              "vision_feature_layer": -2,
              "vision_feature_select_strategy": "default",
              "torch_dtype": "bfloat16"}
    return write_tensors(ckpt, layout, config, make)


def write_mamba(ckpt: Path, seed: int) -> tuple:
    """Mamba-2.8B at MAMBA_LAYERS layers: A_log = log(1..N) and D = 1 as
    HF initialises them, dt's bias the inverse softplus of 0.01,
    matrices at 1/sqrt(fan-in), the tied embedding at 1/sqrt(D)."""
    import math

    import torch

    c = {**MAMBA_28B, "num_hidden_layers": MAMBA_LAYERS}
    D, Di, N = c["hidden_size"], c["intermediate_size"], c["state_size"]
    R, K = c["time_step_rank"], c["conv_kernel"]
    layout = [("backbone.embeddings.weight", (c["vocab_size"], D)),
              ("backbone.norm_f.weight", (D,))]
    for i in range(MAMBA_LAYERS):
        p = f"backbone.layers.{i}."
        layout += [(p + "norm.weight", (D,)),
                   (p + "mixer.A_log", (Di, N)), (p + "mixer.D", (Di,)),
                   (p + "mixer.conv1d.weight", (Di, 1, K)),
                   (p + "mixer.conv1d.bias", (Di,)),
                   (p + "mixer.in_proj.weight", (2 * Di, D)),
                   (p + "mixer.x_proj.weight", (R + 2 * N, Di)),
                   (p + "mixer.dt_proj.weight", (Di, R)),
                   (p + "mixer.dt_proj.bias", (Di,)),
                   (p + "mixer.out_proj.weight", (D, Di))]
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(name, shape):
        bf = dict(dtype=torch.bfloat16, device=dev)
        if name.endswith("A_log"):
            return torch.log(torch.arange(1, N + 1, device=dev).float()
                             ).expand(shape).to(torch.bfloat16)
        if name.endswith(("norm.weight", "norm_f.weight", "mixer.D")):
            return torch.ones(shape, **bf)
        if name.endswith("dt_proj.bias"):
            return torch.full(shape, math.log(math.expm1(0.01)), **bf)
        if name.endswith("conv1d.bias"):
            return torch.zeros(shape, **bf)
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * math.prod(shape[1:]) ** -0.5).to(torch.bfloat16)

    return write_tensors(ckpt, layout, c, make)


def write_rwkv(ckpt: Path, seed: int) -> tuple:
    """RWKV-4-3B at RWKV_LAYERS layers: LayerNorms 1 and 0, the mixes
    uniform in [0, 1], decays and bonuses at 0, matrices at
    1/sqrt(fan-in)."""
    import torch

    c = {**RWKV4_3B, "num_hidden_layers": RWKV_LAYERS}
    D, F, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    layout = [("rwkv.embeddings.weight", (V, D)),
              ("rwkv.blocks.0.pre_ln.weight", (D,)),
              ("rwkv.blocks.0.pre_ln.bias", (D,))]
    for i in range(RWKV_LAYERS):
        b = f"rwkv.blocks.{i}."
        layout += [(b + f"{n}.{w}", (D,)) for n in ("ln1", "ln2")
                   for w in ("weight", "bias")]
        layout += [(b + "attention.time_decay", (D,)),
                   (b + "attention.time_first", (D,))]
        layout += [(b + f"attention.time_mix_{m}", (1, 1, D))
                   for m in ("key", "value", "receptance")]
        layout += [(b + f"attention.{m}.weight", (D, D))
                   for m in ("key", "value", "receptance", "output")]
        layout += [(b + "feed_forward.time_mix_key", (1, 1, D)),
                   (b + "feed_forward.time_mix_receptance", (1, 1, D)),
                   (b + "feed_forward.key.weight", (F, D)),
                   (b + "feed_forward.receptance.weight", (D, D)),
                   (b + "feed_forward.value.weight", (D, F))]
    layout += [("rwkv.ln_out.weight", (D,)), ("rwkv.ln_out.bias", (D,)),
               ("head.weight", (V, D))]
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(name, shape):
        bf = dict(dtype=torch.bfloat16, device=dev)
        if "time_mix" in name:
            return torch.rand(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        if name.endswith(("time_decay", "time_first", ".bias")):
            return torch.zeros(shape, **bf)
        if len(shape) == 1:
            return torch.ones(shape, **bf)
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * shape[1] ** -0.5).to(torch.bfloat16)

    return write_tensors(ckpt, layout, c, make)


def smoke_pngs(seed: int) -> list:
    """Three PNGs unlike each other in structure (two noise images of one
    distribution give a random tower nearly the same pooled rows), each
    a size other than the towers' (so every one is resized): a smooth
    red-to-blue field 640 x 480 with noise from ``seed``, a gradient 300
    x 500, a black-and-white checkerboard of 64-pixel squares 512 x
    512."""
    import numpy as np

    from localai_tfp_tpu_torch.models.image_io import encode_png

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:480, 0:640]
    field = np.stack([255 - x * 255 // 640, y * 64 // 480, x * 255 // 640],
                     axis=-1) + rng.integers(0, 16, (480, 640, 3))
    y, x = np.mgrid[0:500, 0:300]
    grad = np.stack([x * 255 // 300, y * 255 // 500, (x + y) % 256],
                    axis=-1)
    y, x = np.mgrid[0:512, 0:512]
    board = np.repeat((((x // 64) + (y // 64)) % 2 * 255)[..., None], 3,
                      axis=-1)
    return [encode_png(a.astype(np.uint8)) for a in (field, grad, board)]


def image_body(model: str, images: list, text: str = IMAGE_TEXT) -> dict:
    import base64

    parts = [{"type": "image_url", "image_url": {
        "url": "data:image/png;base64," + base64.b64encode(b).decode()}}
        for b in images]
    return {"model": model, "stream": True, "max_tokens": IMAGE_TOKENS,
            "temperature": 0.0, "ignore_eos": True, "messages": [
                {"role": "user",
                 "content": [{"type": "text", "text": text}] + parts}]}


def tower_ms(backend, images: list) -> dict:
    """Device ms of the tower and projector (CUDA events): one image by
    the served graph's replay, and eagerly (``encode_images``) one image
    and ``images`` in one call, by image."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models.image_io import preprocess_image
    from localai_tfp_tpu_torch.models.vision import encode_images

    vspec, vp, mm = backend.vision
    t0 = time.perf_counter()
    pix = torch.from_numpy(np.stack([preprocess_image(
        b, mm["image_size"], mm["family"]) for b in images])).to(
        CARD, vp["patch_w"].dtype)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    one = _time_ms(lambda: encode_images(vspec, vp, pix[:1]), 3)
    many = _time_ms(lambda: encode_images(vspec, vp, pix), 3)
    replay = (_time_ms(backend.tower.graph.replay, 3)
              if backend.tower.graph is not None else None)
    return {"tower_ms_per_image_replay": replay,
            "tower_graph_pool_bytes": backend.tower.pool_bytes,
            "tower_ms_per_image": one,
            "tower_ms_per_image_batched": many / len(images),
            "images_batched": len(images),
            "host_decode_resize_ms_per_image": decode_ms,
            "tower_layers": vspec.n_layers, "patches": vspec.n_patches,
            "soft_tokens": vspec.mm_tokens}


def image_leg(backend, res: dict, model: str, layers: int, smi: str,
              tag: str, by_m: bool = False, itl: bool = False) -> dict:
    """Phase families' and recurrent_vision's image chats on a loaded
    multimodal model: two PNGs in one streamed chat, the same text with
    another image, and the text alone. Checks that the image prefill ran
    as replays of mixed variants captured at load (each with its soft
    buffers, and none captured mid-request), that B1 launched once
    per layer of every forward (B2, ``by_m``, once per call counted by
    M), that each chat's greedy ids are the dense forward's with the
    same soft rows, and that the two image chats' ids differ; records
    the tower's device ms per image and the engine's first-token ms of
    the image chats against the text chat's. With ``itl``, the ITL of
    live text streams while a two-image chat is admitted beside them
    (its tower runs in the route's thread, on the engine's stream),
    against the same streams alone."""
    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    port, eng = res["port"], backend.engine
    at_load = sorted(k for k, v in eng._mixed_variants.items()
                     if v.soft is not None and (v.graph is not None
                                                or CARD == "cpu"))
    if not at_load or len(at_load) != len(eng._mixed_variants):
        raise AssertionError(f"{model}: mixed variants with soft buffers "
                             f"captured at load: {at_load} of "
                             f"{sorted(eng._mixed_variants)}")
    pngs = smoke_pngs(7)
    tower = tower_ms(backend, pngs[:2])
    reqs, ids = [], []
    to_request, finish = backend._to_request, eng._finish

    def spy_request(opts):
        r = to_request(opts)
        reqs.append(r)
        return r

    def spy_finish(slot, reason):
        ids.append(list(slot.generated))
        return finish(slot, reason)

    backend._to_request, eng._finish = spy_request, spy_finish
    counts = undo = None
    if by_m:
        counts, undo = _b2_by_m(eng)
    m = eng.metrics
    before = (m.forward_steps, m.mixed_steps, m.mixed_replays,
              m.decode_steps, m.graph_replays, m.soft_steps, m.soft_replays)
    tower_replays = backend.tower.replays
    torch.cuda.synchronize()
    ragged_paged_attention.launches = int8_matmul.launches = 0
    chats = {}
    try:
        for key, images in (("two_images", pngs[:2]),
                            ("another_image", [pngs[2], pngs[1]])):
            r = stream_post(port, "/v1/chat/completions",
                            image_body(model, images), {"Extra-Usage": "1"})
            chats[key] = r["frames"][-1]["usage"]
        launched = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
        calls_by_m = dict(sorted(counts.items())) if by_m else None
        fwd, mixed, mrep, dec, drep, soft, srep = (
            a - b for a, b in zip((m.forward_steps, m.mixed_steps,
                                   m.mixed_replays, m.decode_steps,
                                   m.graph_replays, m.soft_steps,
                                   m.soft_replays), before))
        text = stream_post(port, "/v1/chat/completions",
                           {**image_body(model, []),
                            "messages": [{"role": "user",
                                          "content": IMAGE_TEXT}]},
                           {"Extra-Usage": "1"})
        chats["text_only"] = text["frames"][-1]["usage"]
        tower_replays = backend.tower.replays - tower_replays
    finally:
        for o in (backend, eng):
            o.__dict__.pop("_to_request", None)
            o.__dict__.pop("_finish", None)
        if undo is not None:
            undo()
    if launched["ragged_paged_attention"] != layers * fwd:
        raise AssertionError(f"{model}: B1 launched "
                             f"{launched['ragged_paged_attention']} times for "
                             f"{fwd} forwards of {layers} layers")
    if CARD != "cpu" and (mrep != mixed or drep != dec or srep != soft
                          or not soft):
        raise AssertionError(f"{model}: image prefill not all replays: "
                             f"mixed {mrep}/{mixed}, decode {drep}/{dec}, "
                             f"soft {srep}/{soft}")
    if CARD != "cpu" and tower_replays != 4:
        raise AssertionError(f"{model}: {tower_replays} tower replays for "
                             f"four images")
    if sorted(eng._mixed_variants) != at_load:
        raise AssertionError(f"{model}: mixed variants captured "
                             f"mid-request: {sorted(eng._mixed_variants)} "
                             f"against {at_load} at load")
    if by_m and (not launched["int8_matmul"]
                 or launched["int8_matmul"] != sum(calls_by_m.values())):
        raise AssertionError(f"{model}: int8_matmul launched "
                             f"{launched['int8_matmul']} times for "
                             f"{calls_by_m}")
    ref = reference_engine(eng)
    dense = []
    for r, got in zip(reqs[:2], ids[:2]):
        n = len(r.soft_positions)
        soft_arg = (r.soft_embeds, torch.zeros(n, dtype=torch.int32,
                                               device=eng.device),
                    torch.as_tensor(r.soft_positions, dtype=torch.int32,
                                    device=eng.device))
        d = dense_deficits(ref, list(r.prompt_ids), got, soft=soft_arg)
        d.update(prompt_tokens=len(r.prompt_ids), soft_rows=n)
        if not d["worst_logit_deficit"] <= d["tol"]:
            raise AssertionError(f"{model}: image chat ids are not the "
                                 f"dense forward's argmax: {d}")
        dense.append(d)
    if ids[0] == ids[1]:
        raise AssertionError(f"{model}: two images gave the same ids "
                             f"{ids}; dense {dense}")
    itl_ms = None
    if itl:
        def image_chat():
            # the route's request: posted, its rows made (the tower
            # launched), its stream ended
            stamps = {"image_chat_posted": time.perf_counter()}

            def timed(opts):
                r = to_request(opts)
                stamps["image_request_made"] = time.perf_counter()
                return r

            backend._to_request = timed
            try:
                stream_post(port, "/v1/chat/completions",
                            image_body(model, pngs[:2]))
            finally:
                del backend._to_request
            stamps["image_chat_ended"] = time.perf_counter()
            return stamps

        alone = itl_streams(eng, backend, [], tokens=ITL_IMAGE_TOKENS)
        beside = itl_streams(eng, backend, [], arrive=image_chat,
                             tokens=ITL_IMAGE_TOKENS)
        t = beside["ms_from_submit"]
        if t["image_request_made"] >= t["streams_last_token"]:
            raise AssertionError(f"{model}: the image chat's request was "
                                 f"made after the streams ended: {t}")
        itl_ms = {"text_streams_alone": alone,
                  "beside_two_image_chat": beside,
                  "streams": DISPATCH_STREAMS,
                  "tokens_each": ITL_IMAGE_TOKENS}
    out = {"model": model, "card": smi, **tower,
           "mixed_variants_at_load": [list(k) for k in at_load],
           "forwards": fwd, "mixed_steps": mixed, "mixed_replays": mrep,
           "decode_forwards": dec, "decode_replays": drep,
           "soft_steps": soft, "soft_replays": srep,
           "tower_replays": tower_replays,
           "launches": launched,
           "b1_launches_per_forward": launched["ragged_paged_attention"]
           / max(1, fwd),
           **({"int8_matmul_calls_by_m": calls_by_m} if by_m else {}),
           # the engine's, submit to token: the tower, launched before
           # the submit, is still ahead of the prefill on the stream
           "first_token_ms": {k: v["timing_first_token"]
                              for k, v in chats.items()},
           "prompt_tokens": {k: v["prompt_tokens"] for k, v in chats.items()},
           "ids": {"two_images": ids[0], "another_image": ids[1],
                   "text_only": ids[2]},
           "dense": dense, "itl_ms": itl_ms,
           "hbm_components": (eng._ledger.attributed()
                              if eng._ledger is not None else None)}
    log(f"{tag}_images", **out)
    return out


def recurrent_leg(models: Path, name: str, write, smi: str, seed: int,
                  cut: str) -> dict:
    """Write one recurrent checkpoint, serve it through the HTTP server
    (its step graphs captured at load), stream a chat and hold the ids
    the server generated to the step function run eagerly on the same
    prompt (bitwise: the graphs replay the same kernels); then host ms
    per decode token by replay against the eager step."""
    import shutil

    import torch

    ckpt = f"{name}-s{seed}"
    nbytes, write_s = write(models / ckpt, seed)
    log("recurrent_vision_checkpoint", model=name, bytes=nbytes,
        write_s=write_s, reduced=cut, card=smi)
    (models / f"{name}.yaml").write_text(json.dumps({
        "name": name, "backend": "torch-llm",
        "parameters": {"model": ckpt, "temperature": 0.0, "max_tokens": 32},
        "context_size": 2048, "dtype": "bfloat16",
        "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                     "chat": "{{.Input}}\nassistant:"}}))
    torch.cuda.reset_peak_memory_stats()
    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        t0 = time.perf_counter()
        backend = _loaded(port, srv.app, name)
        load_and_first = time.perf_counter() - t0
        mod, spec, params, run = backend.recurrent
        got = []
        generate = run.generate

        def spy(prompt, *a, **kw):
            out = generate(prompt, *a, **kw)
            got.append((list(prompt), out.tolist()))
            return out

        run.generate = spy
        try:
            replays = run.replays
            body = {"model": name, "stream": True, "max_tokens": 32,
                    "ignore_eos": True, "temperature": 0.0,
                    "messages": [{"role": "user", "content": IMAGE_TEXT}]}
            r = stream_post(port, "/v1/chat/completions", body)
            usage = r["frames"][-1].get("usage") or {}
        finally:
            del run.generate
        prompt, ids = got[-1]
        if CARD != "cpu" and run.replays - replays != len(prompt) + len(ids):
            raise AssertionError(f"{name}: {run.replays - replays} replays "
                                 f"for {len(prompt)} + {len(ids)} steps")
        eager = mod.runner(spec, params, backend.device, eager=True)
        want = eager.generate(prompt, len(ids)).tolist()
        if want != ids:
            raise AssertionError(f"{name}: served ids {ids} are not the "
                                 f"eager step's {want}")
        timed = {"replay": [], "eager": []}
        for rr in (run, eager):
            rr.generate(prompt[:4], 8)  # warm
        for _ in range(RECURRENT_REPEATS):  # the two ways interleaved
            for way, rr in (("replay", run), ("eager", eager)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                rr.generate(prompt[:4], RECURRENT_TOKENS)
                torch.cuda.synchronize()
                timed[way].append((time.perf_counter() - t) * 1e3 / (
                    RECURRENT_TOKENS + 4))
        out = {"model": name, "card": smi, "reduced": cut,
               "load_s": round(backend.load_s, 3),
               "load_and_first_request_s": round(load_and_first, 3),
               "checkpoint_bytes": nbytes, "prompt_tokens": len(prompt),
               "ids": ids, "ids_equal_eager_step": True,
               "completion_tokens": usage.get("completion_tokens"),
               # the median of RECURRENT_REPEATS runs, and every run
               "host_ms_per_token_replay": sorted(timed["replay"])[
                   RECURRENT_REPEATS // 2],
               "host_ms_per_token_eager": sorted(timed["eager"])[
                   RECURRENT_REPEATS // 2],
               "host_ms_per_token_runs": timed,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        log("recurrent_vision_" + name.split("-")[0], **out)
        return out
    finally:
        _shut(srv, th)
        shutil.rmtree(models / ckpt, ignore_errors=True)


def phase_recurrent_vision(smi: str, seed: int) -> dict:
    """(a) LLaVA-1.5-7B: the CLIP ViT-L/14-336 tower at full depth and the
    Llama-2-7B decoder at full width and LLAVA_LAYERS layers, an image
    chat through the server (soft variants by replay, B1 per layer of
    every forward, greedy ids against the dense forward with the soft
    rows); (b) Mamba-2.8B at MAMBA_LAYERS and (c) RWKV-4-3B at
    RWKV_LAYERS layers, a chat each through the server, ids against the
    eager step, host ms per token by replay and eagerly."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "recurrent_vision"
    models.mkdir(parents=True, exist_ok=True)
    out = {}
    cut = (f"decoder layers {LLAVA_LAYERS} of "
           f"{LLAVA_TEXT['num_hidden_layers']}")
    ckpt = f"llava15-7b-L{LLAVA_LAYERS}-s{seed}"
    nbytes, write_s = write_llava(models / ckpt, seed)
    log("recurrent_vision_checkpoint", model="llava15_7b", bytes=nbytes,
        write_s=write_s, reduced=cut, card=smi)
    family_yaml(models, "llava15_7b", ckpt)
    torch.cuda.reset_peak_memory_stats()
    res = serve_family(
        models, "llava15_7b", smi,
        lambda b: [image_body("llava15_7b", smoke_pngs(3)[:1])],
        "Say hello.", LLAVA_LAYERS, True, tag="recurrent_vision_llava",
        after=lambda b, r: image_leg(b, r, "llava15_7b", LLAVA_LAYERS, smi,
                                     "recurrent_vision_llava"))
    res.update(reduced=cut, checkpoint_bytes=nbytes,
               peak_allocated_bytes=torch.cuda.max_memory_allocated())
    res.pop("port", None)
    out["llava15_7b"] = res
    shutil.rmtree(models / ckpt, ignore_errors=True)
    out["mamba_2_8b"] = recurrent_leg(
        models, "mamba-2.8b", write_mamba, smi, seed,
        f"layers {MAMBA_LAYERS} of {MAMBA_28B['num_hidden_layers']}")
    out["rwkv4_3b"] = recurrent_leg(
        models, "rwkv-4-3b", write_rwkv, smi, seed,
        f"layers {RWKV_LAYERS} of {RWKV4_3B['num_hidden_layers']}")
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("recurrent_vision", card=smi, phase_s=out["phase_s"],
        llava_load_s=res["load"]["load_s"],
        llava_tower_ms_per_image=res["after"]["tower_ms_per_image"],
        **{k: {"load_s": out[k]["load_s"],
               "host_ms_per_token_replay": out[k]["host_ms_per_token_replay"],
               "host_ms_per_token_eager": out[k]["host_ms_per_token_eager"]}
           for k in ("mamba_2_8b", "rwkv4_3b")})
    return out


def paged_logits(eng, seq: list):
    """Logits [len(seq), V] f32 of ``seq`` in one paged prefill forward
    over a scratch arena in the engine's page size, as ``LLMEngine.embed``
    runs its forward: each layer's attention is whatever
    ``transformer.ragged_paged_attention`` names (B1 on a card)."""
    import torch

    from localai_tfp_tpu_torch.models.transformer import KVCache, forward

    n, pg, dev = len(seq), eng.page, eng.device
    n_pages = -(-n // pg)
    toks = torch.zeros((1, n_pages * pg), dtype=torch.int32)
    toks[0, :n] = torch.tensor(seq, dtype=torch.int32)
    # scratch page 0 is the trash page the pad positions write
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)[None]
    with eng._device_lock, torch.inference_mode():
        scratch = KVCache.create(eng.spec, 1 + n_pages, pg,
                                 eng.cache.k.dtype, device=dev)
        logits, _ = forward(
            eng.spec, eng.params, toks.to(dev),
            torch.zeros(1, dtype=torch.int32, device=dev), scratch,
            page_table=table, kv_page=pg,
            q_lens=torch.tensor([n], dtype=torch.int32, device=dev),
            write_table=table)
    return logits[0, :n].float()


def phase_softcap_witness(smi: str, seed: int) -> dict:
    """Gemma-2-2B at full width and depth with every layer's q_proj at
    4x and at 1x the attention softcap (``saturate="every"``), the
    weights phase families gave up, each served as phase families
    serves Gemma 2 (its two greedy chats at once, then one greedy
    request): that request's ids held to the dense forward in bf16 (as
    phase families holds them) and in f32, and one paged forward of the
    same tokens through B1 against the same forward with the plain
    attention, and layer by layer B1's output against the plain
    attention's on B1's own inputs. It records and fails only on a
    non-finite logit; not in the default list."""
    import shutil

    import torch

    from localai_tfp_tpu_torch.models import transformer as tt
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_attention_plain, ragged_paged_attention,
    )

    models = ROOT / "build" / "chip_smoke" / "family_models"
    models.mkdir(parents=True, exist_ok=True)
    layers = GEMMA2_2B["num_hidden_layers"]
    res = {}
    for q_cap_scale in (4.0, 1.0):
        t0 = time.perf_counter()
        name = f"gemma2_every_x{q_cap_scale:g}"
        ckpt = f"{name}-L{layers}-s{seed}"
        write_family_checkpoint(models / ckpt, GEMMA2_2B, layers, seed,
                                saturate="every", q_cap_scale=q_cap_scale)
        family_yaml(models, name, ckpt)
        srv, th = _serve(models)
        try:
            port = srv.server_address[1]
            backend = _loaded(port, srv.app, name)
            eng = backend.engine
            burst = family_burst(port, name, eng, family_chats()[1:3])
            prompt, ids = served_greedy(backend, "Name three colours.", 16)
            out = {"model": name, "layers": layers,
                   "q_cap_scale": q_cap_scale,
                   "burst_forwards": burst["forward_steps"],
                   "prompt_tokens": len(prompt), "ids": ids,
                   "dense_bf16": dense_deficits(eng, prompt, ids),
                   "dense_f32": dense_deficits(
                       reference_engine(eng, torch.float32), prompt, ids,
                       cache_dtype=torch.float32)}
            seq = prompt + ids[:-1]
            rows = slice(len(prompt) - 1, None)  # one per generated token
            per_layer = []

            def both(*a, **kw):  # B1, and the plain attention beside it
                got = ragged_paged_attention(*a, **kw)
                want = ragged_attention_plain(*a, **kw).float()
                per_layer.append(
                    (float((got.float() - want).abs().max()),
                     float(want.abs().max())))
                return got

            n0 = ragged_paged_attention.launches
            tt.ragged_paged_attention = both
            try:
                b1 = paged_logits(eng, seq)[rows]
            finally:
                tt.ragged_paged_attention = ragged_paged_attention
            launched = ragged_paged_attention.launches - n0
            tt.ragged_paged_attention = ragged_attention_plain
            try:
                plain = paged_logits(eng, seq)[rows]
            finally:
                tt.ragged_paged_attention = ragged_paged_attention
            if not bool(torch.isfinite(b1).all()
                        & torch.isfinite(plain).all()):
                raise AssertionError("softcap witness: a logit is not "
                                     "finite")
            tok = torch.tensor(ids, device=b1.device)

            def held(lg):
                d = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
                return {"exact_argmax": int((lg.argmax(-1) == tok).sum()),
                        "worst_logit_deficit": float(d.max()),
                        "tol": 0.25 * float(lg.std())}

            out["paged"] = {
                "b1_launches": launched,
                "max_abs_diff_b1_plain": float((b1 - plain).abs().max()),
                "logit_std": float(plain.std()),
                "argmax_equal": int((b1.argmax(-1)
                                     == plain.argmax(-1)).sum()),
                "served_vs_b1": held(b1), "served_vs_plain": held(plain),
                # each layer's B1 output against the plain attention on
                # the same inputs (B1's own forward): max |diff|, max |out|
                "per_layer_b1_vs_plain": per_layer}
            out["s"] = round(time.perf_counter() - t0, 3)
            log("softcap_witness", card=smi, **out)
            res[name] = out
        finally:
            _shut(srv, th)
            shutil.rmtree(models / ckpt, ignore_errors=True)
            torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase moe


# Qwen/Qwen1.5-MoE-A2.7B-Chat's published config.json
QWEN15_MOE = {
    "model_type": "qwen2_moe", "hidden_size": 2048,
    "intermediate_size": 5632, "num_attention_heads": 16,
    "num_key_value_heads": 16, "num_hidden_layers": 24,
    "vocab_size": 151936, "max_position_embeddings": 8192,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "hidden_act": "silu",
    "sliding_window": 32768, "use_sliding_window": False,
    "max_window_layers": 21, "tie_word_embeddings": False,
    "decoder_sparse_step": 1, "moe_intermediate_size": 1408,
    "shared_expert_intermediate_size": 5632, "num_experts_per_tok": 4,
    "num_experts": 60, "norm_topk_prob": False, "bos_token_id": 151643,
    "eos_token_id": 151645,
}
# Qwen/Qwen3-30B-A3B's published config.json
QWEN3_MOE = {
    "model_type": "qwen3_moe", "hidden_size": 2048, "head_dim": 128,
    "intermediate_size": 6144, "num_attention_heads": 32,
    "num_key_value_heads": 4, "num_hidden_layers": 48,
    "vocab_size": 151936, "max_position_embeddings": 40960,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "hidden_act": "silu",
    "attention_bias": False, "decoder_sparse_step": 1,
    "mlp_only_layers": [], "moe_intermediate_size": 768,
    "norm_topk_prob": True, "num_experts": 128, "num_experts_per_tok": 8,
    "sliding_window": None, "use_sliding_window": False,
    "tie_word_embeddings": False, "bos_token_id": 151643,
    "eos_token_id": 151645,
}
QWEN3_MOE_LAYERS = 8  # a depth cut: 61 GB in bf16 at all 48
QWEN15_MOE_LAYERS = 8  # a depth cut of the run's time: 75-77 s at all 24
# the MoE block against a per-token loop over each token's routed experts
# (and the shared expert) in f32/f64: bf16 products and sums move the
# output by a few bf16 units of its largest value; one wrong expert or
# gate moves a token's output by the whole value
MOE_BLOCK_TOL = 0.03  # of max|reference|
ROUTE_TIE = 1e-6  # expert sets may differ only where the k-th and
# (k+1)-th router logits are this close
MOE_BLOCK_TOKENS = 64


def moe_block_check(eng, layer: int, seed: int) -> dict:
    """Layer ``layer``'s mixture-of-experts block (``transformer._moe_mlp``
    on the card) against an independent formulation on the same bf16
    inputs: f64 router logits, ``torch.topk``, and for each token a loop
    over its routed experts' gate/up/down products in f32, weighted in
    f64, plus the shared expert scaled by its sigmoid gate. Fails above
    ``MOE_BLOCK_TOL`` x max|reference| or where a token's expert set
    differs without a router near tie."""
    import torch

    from localai_tfp_tpu_torch.models import transformer as tt

    spec, dev = eng.spec, eng.device
    lp = {k: v[layer] for k, v in eng.params.items()
          if k not in tt._NON_LAYER_KEYS}
    E, K, D = spec.n_experts, spec.experts_per_token, spec.d_model
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, MOE_BLOCK_TOKENS, D), generator=g,
                    device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        got = tt._moe_mlp(spec, lp, x)[0].float()
        port_logits = tt._router_logits(x[0], lp["router"])
        scores = (port_logits if spec.moe_norm_topk
                  else torch.softmax(port_logits, -1))
        _, port_idx = tt._top_k(scores, K)
        xs = x[0].double()
        logits = xs @ lp["router"].double()
        probs = torch.softmax(logits, -1)
        vals, idx = torch.topk(logits, min(K + 1, E), dim=-1)
        ref = torch.zeros((MOE_BLOCK_TOKENS, D), dtype=torch.float64,
                          device=dev)
        act = torch.nn.functional.silu
        f32: dict = {}  # each routed expert's weights, widened once

        def expert(e):
            if e not in f32:
                f32[e] = tuple(lp[k][e].float()
                               for k in ("moe_gate", "moe_up", "moe_down"))
            return f32[e]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products
        try:
            for t in range(MOE_BLOCK_TOKENS):
                sel = idx[t, :K]
                w = (torch.softmax(logits[t, sel], -1)
                     if spec.moe_norm_topk else probs[t, sel])
                xt = x[0, t].float()
                for j, e in enumerate(sel.tolist()):
                    wg, wu, wd = expert(e)
                    h = act(xt @ wg) * (xt @ wu)
                    ref[t] += w[j] * (h @ wd).double()
                if "shared_gate" in lp:
                    s = (act(xt @ lp["shared_gate"].float())
                         * (xt @ lp["shared_up"].float())) @ \
                        lp["shared_down"].float()
                    ref[t] += torch.sigmoid(
                        xs[t] @ lp["shared_router"].double()) * s.double()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del f32
    err = float((got.double() - ref).abs().max())
    bound = MOE_BLOCK_TOL * float(ref.abs().max())
    differ, near_ties = 0, 0
    for t in range(MOE_BLOCK_TOKENS):
        if set(port_idx[t].tolist()) != set(idx[t, :K].tolist()):
            differ += 1
            if K < E and float(vals[t, K - 1] - vals[t, K]) < ROUTE_TIE:
                near_ties += 1
    out = {"layer": layer, "tokens": MOE_BLOCK_TOKENS, "experts": E,
           "top_k": K, "max_abs_err": err, "tol": bound,
           "max_abs_ref": float(ref.abs().max()),
           "expert_sets_differ": differ, "of_which_near_ties": near_ties,
           "shared_expert": "shared_gate" in lp,
           "renormalized_top_k": spec.moe_norm_topk}
    if not err <= bound or differ != near_ties:
        raise AssertionError(f"MoE block against the per-token loop: {out}")
    return out


def phase_moe(smi: str, seed: int) -> dict:
    """(a) Qwen1.5-MoE-A2.7B-Chat at full width and 8 of its 24 layers,
    (b) Qwen3-30B-
    A3B at full width and 8 of its 48 layers: each written from its
    published config.json with random bf16 weights, served through the
    HTTP server (four streamed chats at once, one past 1024 prompt
    tokens; B1 once per layer of every forward, every forward a replay;
    a greedy request held to the dense forward on the plain attention),
    one layer's expert block checked against the per-token loop, and its
    files removed before the next is written (see main: the disk a call
    may write is bounded)."""
    import shutil

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "moe_models"
    models.mkdir(parents=True, exist_ok=True)
    out = {}
    chats = family_chats()
    for key, g, layers, cut in (
            ("qwen15_moe", QWEN15_MOE, QWEN15_MOE_LAYERS,
             f"layers {QWEN15_MOE_LAYERS} of "
             f"{QWEN15_MOE['num_hidden_layers']}"),
            ("qwen3_moe", QWEN3_MOE, QWEN3_MOE_LAYERS,
             f"layers {QWEN3_MOE_LAYERS} of "
             f"{QWEN3_MOE['num_hidden_layers']}")):
        ckpt = f"{key}-L{layers}-s{seed}"
        free = shutil.disk_usage(models).free
        nbytes, write_s = write_family_checkpoint(models / ckpt, g, layers,
                                                  seed)
        log("moe_checkpoint", model=key, bytes=nbytes,
            write_s=round(write_s, 3), layers=layers, reduced=cut,
            disk_free_before=free, card=smi)
        family_yaml(models, key, ckpt)

        def block(backend, res, layers=layers):
            chk = moe_block_check(backend.engine, layers // 2, seed + 7)
            log("moe_block", model=key, card=smi, **chk)
            return chk

        res = serve_family(models, key, smi, chats, LONG_PROMPT, layers,
                           True, profile=key == "qwen15_moe", tag="moe",
                           after=block)
        long = res["burst"]["requests"][0]["prompt_tokens"]
        if long < 1024:
            raise AssertionError(f"{key}: the long chat has {long} tokens")
        res.update(layers=layers, reduced=cut, checkpoint_bytes=nbytes)
        out[key] = res
        shutil.rmtree(models / ckpt, ignore_errors=True)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("moe", card=smi, phase_s=out["phase_s"], **_leg_summary(out))
    return out


def _leg_summary(out: dict) -> dict:
    return {k: {"load_s": v["load"]["load_s"],
                "warmup_s": v["load"]["warmup_s"],
                "graph_pool_bytes": v["load"]["graph_pool_bytes"],
                "first_token_ms": [r["first_token_ms"]
                                   for r in v["burst"]["requests"]],
                "ms_per_decode_forward": v["burst"]["ms_per_decode_forward"],
                "b1_launches_per_forward":
                    v["burst"]["launches"]["ragged_paged_attention"]
                    / max(1, v["burst"]["forward_steps"])}
            for k, v in out.items() if isinstance(v, dict)}


# ---------------------------------------------------------- phase gguf

GGUF_ALIGN = 32
# ggml types of the files written here: F32 norms, llama.cpp's Q4_K_M mix
GGML_F32, GGML_Q4_K, GGML_Q6_K = 0, 12, 14
GGML_BLOCK = {GGML_F32: (1, 4), GGML_Q4_K: (256, 144),
              GGML_Q6_K: (256, 210)}
# Mistral-AI/Mixtral-8x7B-Instruct-v0.1's published config.json
MIXTRAL = {"hidden_size": 4096, "intermediate_size": 14336,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "num_hidden_layers": 32, "vocab_size": 32000,
           "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
           "max_position_embeddings": 32768, "num_local_experts": 8,
           "num_experts_per_tok": 2}
MIXTRAL_LAYERS = 4  # a depth cut: ~93 GB in bf16 at all 32
# the published Mixtral-8x7B-Instruct-v0.1 chat template
MIXTRAL_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}{% if (message['role'] == "
    "'user') != (loop.index0 % 2 == 0) %}{{ raise_exception('Conversation "
    "roles must alternate user/assistant/user/assistant/...') }}{% endif %}"
    "{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + "
    "' [/INST]' }}{% elif message['role'] == 'assistant' %}{{ "
    "message['content'] + eos_token}}{% else %}{{ raise_exception('Only "
    "user and assistant roles are supported!') }}{% endif %}{% endfor %}")
GGUF_LORA_RANK = 16
GGUF_LORA_SCALE = 0.5
GGUF_LORA_PROJ = (("self_attn", "q_proj", "wq"), ("self_attn", "k_proj", "wk"),
                  ("self_attn", "v_proj", "wv"), ("self_attn", "o_proj", "wo"),
                  ("mlp", "gate_proj", "w_gate"), ("mlp", "up_proj", "w_up"),
                  ("mlp", "down_proj", "w_down"))


def _gguf_kv(key: str, kind: str, value) -> bytes:
    import struct

    codes = {"u32": (4, "<I"), "i32": (5, "<i"), "f32": (6, "<f"),
             "str": (8, None)}

    def pack(k, v):
        if k == "str":
            b = v.encode("utf-8")
            return struct.pack("<Q", len(b)) + b
        return struct.pack(codes[k][1], v)

    out = struct.pack("<Q", len(key)) + key.encode()
    if kind.startswith("arr:"):
        et = kind[4:]
        if et == "str":
            body = b"".join(pack("str", v) for v in value)
        else:
            import numpy as np

            body = np.asarray(value, {"u32": "<u4", "i32": "<i4",
                                      "f32": "<f4"}[et]).tobytes()
        return (out + struct.pack("<IIQ", 9, codes[et][0], len(value))
                + body)
    return out + struct.pack("<I", codes[kind][0]) + pack(kind, value)


def gguf_blocks(gt: int, shape: tuple, std: float, gen):
    """Random blocks of ggml type ``gt`` for a tensor of ``shape`` (numpy
    order), made on the card with sane scales and no quantizer: Q4_K
    (d, dmin f16 around ``std / 224`` and 7.5x that, random 6-bit scales
    and mins and 4-bit values: zero mean, std ~``std``), Q6_K (d around
    ``std / 1365``, random int8 scales and 6-bit values), F32 normal at
    ``std`` (ones for ``std=None``: norm weights). Returns uint8 bytes on
    the card."""
    import math

    import torch

    n = math.prod(shape)
    dev = torch.device(CARD)
    if gt == GGML_F32:
        w = (torch.ones(n, device=dev) if std is None
             else torch.randn(n, generator=gen, device=dev) * std)
        return w.view(torch.uint8)
    block, nbytes = GGML_BLOCK[gt]
    nb = n // block
    b = torch.randint(0, 256, (nb, nbytes), generator=gen, device=dev,
                      dtype=torch.uint8)
    jitter = torch.rand((nb, 1), generator=gen, device=dev) + 0.5
    if gt == GGML_Q4_K:
        d = jitter * (std / 224)
        b[:, 0:2] = d.half().view(torch.uint8)
        b[:, 2:4] = (7.5 * d).half().view(torch.uint8)
    else:
        b[:, 208:210] = (jitter * (std / 1365)).half().view(torch.uint8)
    return b.reshape(-1)


def write_gguf(path: Path, meta: list, tensors: list, seed: int) -> int:
    """A GGUF v3 file: ``meta`` [(key, kind, value)], ``tensors`` [(name,
    ggml type, numpy-order shape, std)], each tensor's blocks made on
    the card by ``gguf_blocks`` and written in turn. Returns bytes."""
    import math
    import struct

    import torch

    gen = torch.Generator(device=CARD).manual_seed(seed)
    head = bytearray(struct.pack("<IIQQ", 0x46554747, 3, len(tensors),
                                 len(meta)))
    for key, kind, value in meta:
        head += _gguf_kv(key, kind, value)
    off = 0
    sizes = []
    for name, gt, shape, _ in tensors:
        block, nbytes = GGML_BLOCK[gt]
        size = math.prod(shape) // block * nbytes
        sizes.append(size)
        head += struct.pack("<Q", len(name)) + name.encode()
        head += struct.pack("<I", len(shape))
        head += struct.pack(f"<{len(shape)}Q", *reversed(shape))
        head += struct.pack("<IQ", gt, off)
        off += -(-size // GGUF_ALIGN) * GGUF_ALIGN
    head += b"\0" * (-len(head) % GGUF_ALIGN)
    with open(path, "wb") as f:
        f.write(head)
        for (name, gt, shape, std), size in zip(tensors, sizes):
            raw = gguf_blocks(gt, shape, std, gen).cpu().numpy()
            assert raw.nbytes == size, name
            raw.tofile(f)
            f.write(b"\0" * (-size % GGUF_ALIGN))
    return path.stat().st_size


def gguf_llama_tensors(g: dict, layers: int, experts: int = 0) -> list:
    """(name, type, shape, std) of a llama-family GGUF in llama.cpp's
    Q4_K_M mix: Q4_K for most tensors, Q6_K for ``output`` and for the
    ``attn_v`` and ``ffn_down`` of every other layer, F32 norms; with
    ``experts``, Mixtral's fused ``ffn_*_exps`` stacks (Q4_K) and an F32
    router. Each matrix's std is 1/sqrt(its fan-in), norms are ones; the
    rows of ``attn_q``/``attn_k`` stand in the interleaved order
    convert_hf_to_gguf writes, which the loader un-permutes."""
    D, F, V = g["hidden_size"], g["intermediate_size"], g["vocab_size"]
    dh = D // g["num_attention_heads"]
    q, kv = g["num_attention_heads"] * dh, g["num_key_value_heads"] * dh
    out = [("token_embd.weight", GGML_Q4_K, (V, D), D ** -0.5),
           ("output_norm.weight", GGML_F32, (D,), None),
           ("output.weight", GGML_Q6_K, (V, D), D ** -0.5)]
    for i in range(layers):
        b = f"blk.{i}."
        more = GGML_Q6_K if i % 2 == 0 else GGML_Q4_K
        out += [(b + "attn_norm.weight", GGML_F32, (D,), None),
                (b + "ffn_norm.weight", GGML_F32, (D,), None),
                (b + "attn_q.weight", GGML_Q4_K, (q, D), D ** -0.5),
                (b + "attn_k.weight", GGML_Q4_K, (kv, D), D ** -0.5),
                (b + "attn_v.weight", more, (kv, D), D ** -0.5),
                (b + "attn_output.weight", GGML_Q4_K, (D, q), q ** -0.5)]
        if experts:
            out += [(b + "ffn_gate_inp.weight", GGML_F32, (experts, D),
                     D ** -0.5),
                    (b + "ffn_gate_exps.weight", GGML_Q4_K, (experts, F, D),
                     D ** -0.5),
                    (b + "ffn_up_exps.weight", GGML_Q4_K, (experts, F, D),
                     D ** -0.5),
                    (b + "ffn_down_exps.weight", GGML_Q4_K, (experts, D, F),
                     F ** -0.5)]
        else:
            out += [(b + "ffn_gate.weight", GGML_Q4_K, (F, D), D ** -0.5),
                    (b + "ffn_up.weight", GGML_Q4_K, (F, D), D ** -0.5),
                    (b + "ffn_down.weight", more, (D, F), F ** -0.5)]
    return out


def gguf_llama_meta(g: dict, layers: int, experts: int = 0) -> list:
    D = g["hidden_size"]
    meta = [("general.architecture", "str", "llama"),
            ("general.alignment", "u32", GGUF_ALIGN),
            ("llama.vocab_size", "u32", g["vocab_size"]),
            ("llama.context_length", "u32", g["max_position_embeddings"]),
            ("llama.embedding_length", "u32", D),
            ("llama.block_count", "u32", layers),
            ("llama.feed_forward_length", "u32", g["intermediate_size"]),
            ("llama.rope.dimension_count", "u32",
             D // g["num_attention_heads"]),
            ("llama.attention.head_count", "u32", g["num_attention_heads"]),
            ("llama.attention.head_count_kv", "u32",
             g["num_key_value_heads"]),
            ("llama.rope.freq_base", "f32", g["rope_theta"]),
            ("llama.attention.layer_norm_rms_epsilon", "f32",
             g["rms_norm_eps"])]
    if experts:
        meta += [("llama.expert_count", "u32", experts),
                 ("llama.expert_used_count", "u32",
                  g["num_experts_per_tok"])]
    return meta


def gguf_bpe_vocab(vocab_size: int = 128256) -> list:
    """A ``gpt2``-kind vocabulary: the generated byte-level BPE
    (``text_vocab``) with Llama-3's special tokens as control tokens,
    bos ``<|begin_of_text|>``, eos ``<|eot_id|>``, and the Llama-3-style
    chat template."""
    vocab, merges = text_vocab(vocab_size)
    n = len(vocab)
    tokens = sorted(vocab, key=vocab.get) + list(LLAMA3_SPECIALS)
    return [("tokenizer.ggml.model", "str", "gpt2"),
            ("tokenizer.ggml.tokens", "arr:str", tokens),
            ("tokenizer.ggml.token_type", "arr:i32",
             [1] * n + [3] * len(LLAMA3_SPECIALS)),
            ("tokenizer.ggml.merges", "arr:str",
             [f"{a} {b}" for a, b in merges]),
            ("tokenizer.ggml.bos_token_id", "u32", n),
            ("tokenizer.ggml.eos_token_id", "u32",
             n + LLAMA3_SPECIALS.index("<|eot_id|>")),
            ("tokenizer.chat_template", "str", TEXT_CHAT_TEMPLATE)]


def gguf_sp_vocab(vocab_size: int = 32000) -> list:
    """A ``llama``-kind (sentencepiece) vocabulary of ``vocab_size``:
    <unk>, <s>, </s>, the 256 ``<0xNN>`` byte pieces, single characters,
    then ``▁``-words and pieces of two to five letters with falling
    scores, and the Mixtral chat template."""
    import itertools

    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    singles = list(letters + letters.upper() + "0123456789.,!?;:'\"-()")
    toks += ["▁"] + singles
    seen = set(toks)
    for n in range(1, 6):
        for combo in itertools.product(letters, repeat=n):
            w = "".join(combo)
            for t in ("▁" + w, w):
                if len(toks) < vocab_size and t not in seen:
                    toks.append(t)
                    seen.add(t)
            if len(toks) >= vocab_size:
                break
        if len(toks) >= vocab_size:
            break
    types += [1] * (len(toks) - len(types))
    k = len(toks) - 259
    scores = [0.0] * 259 + [-1.0 - 12.0 * i / k for i in range(k)]
    return [("tokenizer.ggml.model", "str", "llama"),
            ("tokenizer.ggml.tokens", "arr:str", toks),
            ("tokenizer.ggml.scores", "arr:f32", scores),
            ("tokenizer.ggml.token_type", "arr:i32", types),
            ("tokenizer.ggml.unknown_token_id", "u32", 0),
            ("tokenizer.ggml.bos_token_id", "u32", 1),
            ("tokenizer.ggml.eos_token_id", "u32", 2),
            ("tokenizer.chat_template", "str", MIXTRAL_TEMPLATE)]


def write_lora_adapter(adir: Path, g: dict, layers: int, seed: int) -> dict:
    """A rank-16 PEFT adapter (f32 safetensors, ``lora_alpha`` 32) on
    q/k/v/o/gate/up/down of every layer of geometry ``g``: A at
    1/sqrt(fan-in), B at 0.05, so each delta is about a fifth of its
    weight."""
    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    D, F = g["hidden_size"], g["intermediate_size"]
    dh = D // g["num_attention_heads"]
    q, kv = g["num_attention_heads"] * dh, g["num_key_value_heads"] * dh
    dims = {"q_proj": (D, q), "k_proj": (D, kv), "v_proj": (D, kv),
            "o_proj": (q, D), "gate_proj": (D, F), "up_proj": (D, F),
            "down_proj": (F, D)}
    gen = torch.Generator(device=CARD).manual_seed(seed)
    r = GGUF_LORA_RANK
    layout = []
    for i in range(layers):
        for part, proj, _ in GGUF_LORA_PROJ:
            base = f"base_model.model.model.layers.{i}.{part}.{proj}"
            fan_in, fan_out = dims[proj]
            layout += [(f"{base}.lora_A.weight", (r, fan_in), fan_in ** -0.5),
                       (f"{base}.lora_B.weight", (fan_out, r), 0.05)]
    adir.mkdir(parents=True, exist_ok=True)

    def tensors():
        for name, shape, std in layout:
            yield name, torch.randn(shape, generator=gen,
                                    device=CARD) * std

    shapes = [(n, torch.empty(s, device="meta")) for n, s, _ in layout]
    save_iter(tensors(), str(adir / "adapter_model.safetensors"),
              shapes=shapes)
    (adir / "adapter_config.json").write_text(json.dumps(
        {"r": r, "lora_alpha": 2 * r, "peft_type": "LORA",
         "target_modules": [p for _, p, _ in GGUF_LORA_PROJ]}))
    return {"rank": r, "tensors": len(layout),
            "bytes": sum(4 * s[0] * s[1] for _, s, _ in layout)}


def long_chat(tk, text: str = LONG_PROMPT, tokens: int = 1100) -> str:
    """``text`` repeated until it encodes to at least ``tokens`` ids."""
    out = text
    while len(tk.encode(out)) < tokens:
        out += text
    return out


def gguf_card_dequant(path: Path) -> dict:
    """For one tensor of each ggml type in the file (the smallest), the
    card's dequantization against the same torch function on the CPU:
    bitwise."""
    import torch

    from localai_tfp_tpu_torch.models.gguf import GGML_TYPE_NAMES, GGUFFile

    gf = GGUFFile(str(path))
    pick = {}
    for ti in gf.tensors.values():
        n = 1
        for d in ti.shape:
            n *= d
        if ti.ggml_type not in pick or n < pick[ti.ggml_type][1]:
            pick[ti.ggml_type] = (ti.name, n)
    out = {}
    for gt, (name, n) in sorted(pick.items()):
        card = gf.tensor(name, CARD).cpu()
        host = gf.tensor(name, "cpu")
        same = bool(torch.equal(card.view(torch.int32),
                                host.view(torch.int32)))
        out[GGML_TYPE_NAMES[gt]] = {"tensor": name, "elements": n,
                                    "bitwise": same}
        if not same:
            raise AssertionError(f"{name}: card dequantization differs from "
                                 f"the CPU's: {out}")
    return out


def qk_permutation_check(eng, path: Path, g: dict) -> dict:
    """Layer 0's served ``wq``/``wk``, put back in the order
    convert_hf_to_gguf writes (its ``permute``), equal the file's rows
    dequantized: the loader inverted exactly that permutation."""
    import torch

    from localai_tfp_tpu_torch.models.gguf import GGUFFile

    gf = GGUFFile(str(path))
    out = {}
    for leaf, tname, heads in (("wq", "blk.0.attn_q.weight",
                                g["num_attention_heads"]),
                               ("wk", "blk.0.attn_k.weight",
                                g["num_key_value_heads"])):
        hf = eng.params[leaf][0].T  # [out, in], rotate-half order
        o, i = hf.shape
        permuted = (hf.reshape(heads, 2, o // heads // 2, i)
                    .transpose(1, 2).reshape(o, i))
        rows = gf.tensor(tname, eng.device).to(hf.dtype)
        out[leaf] = bool(torch.equal(permuted, rows))
        if not out[leaf]:
            raise AssertionError(f"{leaf}: served rows are not the file's "
                                 "un-permuted")
    return out


def lora_leaf_check(eng, path: Path, adir: Path, scale: float) -> dict:
    """Layer 0's merged ``wv`` on the card against W + scale x (alpha/r)
    x (B A)^T computed in f64 on the host from the file's dequantized
    weight and the adapter: within one bf16 unit of each value, plus the
    f32 rounding of the larger operand (the merge adds in f32, as the
    JAX package's does: where W and the delta nearly cancel, that
    rounding is more than a unit of the small sum)."""
    import torch

    from localai_tfp_tpu_torch.models.gguf import GGUFFile
    from localai_tfp_tpu_torch.models.safetensors_io import SafeTensorsFile

    w = GGUFFile(str(path)).tensor("blk.0.attn_v.weight", "cpu").T \
        .to(torch.bfloat16).double()
    st = SafeTensorsFile(str(adir / "adapter_model.safetensors"))
    base = "base_model.model.model.layers.0.self_attn.v_proj"
    a = st.get(base + ".lora_A.weight").double()
    b = st.get(base + ".lora_B.weight").double()
    cfg = json.loads((adir / "adapter_config.json").read_text())
    delta = (b @ a).T * (cfg["lora_alpha"] / cfg["r"]) * scale
    want = w + delta
    got = eng.params["wv"][0].double().cpu()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(
        2.0 ** -126))) - 7)
    f32 = 2.0 ** -23 * torch.maximum(w.abs(), delta.abs())
    err = (got - want).abs()
    units = float((err / (ulp + f32)).max())
    moved = float((got - w).abs().max())
    out = {"leaf": "wv[0]", "max_err_in_units": units,
           "max_bf16_units_alone": float((err / ulp).max()),
           "max_abs_delta": moved}
    if not units <= 1.0 or not moved > 0:
        raise AssertionError(f"merged LoRA leaf: {out}")
    return out


def phase_gguf(smi: str, seed: int, layers: int | None = None) -> dict:
    """(a) a Llama-3.1-8B-geometry GGUF in the Q4_K_M mix at full width and
    depth with a byte-level BPE vocabulary of 128256 and a Llama-3 chat
    template, (b) the same file with a rank-16 LoRA adapter at scale 0.5
    (then removed and applied again on the running engine), (c) the same
    file with ``quantization: int8`` (B2 by M), (d) a Mixtral-8x7B-
    geometry GGUF (4 of its 32 layers, Q4_K experts) with a sentencepiece
    vocabulary of 32000: each through the HTTP server with the file's
    own tokenizer and chat template, four streamed chats at once (one
    past 1024 prompt tokens), B1 once per layer of every forward, every
    forward a replay, a greedy request held to the dense forward. Each
    file is removed after its last leg. ``layers`` cuts the 8B file's
    depth (``--gguf-layers``; full depth by default)."""
    import shutil

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "gguf_models"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    out: dict = {}
    t0 = time.perf_counter()
    f8 = models / "llama31-8b-Q4_K_M.gguf"
    L8 = layers or GEOMETRY["num_hidden_layers"]
    cut8 = (None if L8 == GEOMETRY["num_hidden_layers"] else
            f"layers {L8} of {GEOMETRY['num_hidden_layers']}")
    nbytes = write_gguf(f8, gguf_llama_meta(GEOMETRY, L8)
                        + gguf_bpe_vocab(GEOMETRY["vocab_size"]),
                        gguf_llama_tensors(GEOMETRY, L8), seed)
    log("gguf_file", model="llama31_8b", bytes=nbytes,
        write_s=round(time.perf_counter() - t0, 3), card=smi)
    lora = write_lora_adapter(models / "lora-8b", GEOMETRY, L8, seed + 1)
    log("gguf_lora_adapter", card=smi, **lora)

    def chats(backend) -> list:
        """Phase families' chats, the long one sized by the file's own
        tokenizer (past 1024 prompt tokens)."""
        bodies = family_chats()
        bodies[0] = {**bodies[0], "messages": [{
            "role": "user", "content": long_chat(backend.tokenizer)}]}
        return bodies

    legs = (
        ("llama31_8b", f8.name, {}, L8, cut8),
        ("llama31_8b_lora", f8.name,
         {"lora_adapters": ["lora-8b"], "lora_scales": [GGUF_LORA_SCALE]},
         L8, cut8),
        ("llama31_8b_int8", f8.name, {"quantization": "int8"}, L8, cut8),
    )
    for key, fname, extra, layers, cut in legs:
        family_yaml(models, key, fname,
                    template={"use_tokenizer_template": True}, **extra)
        out[key] = gguf_leg(models, key, smi, layers, f8, chats,
                            int8="quantization" in extra,
                            lora=models / "lora-8b" if "lora_adapters"
                            in extra else None)
        out[key].update(layers=layers, reduced=cut, file_bytes=nbytes)
    f8.unlink()
    shutil.rmtree(models / "lora-8b", ignore_errors=True)
    # (d) Mixtral's geometry, 4 of 32 layers, its own vocabulary
    t0 = time.perf_counter()
    fm = models / "mixtral-8x7b-L4-Q4_K_M.gguf"
    E = MIXTRAL["num_local_experts"]
    gm = {**MIXTRAL, "model_type": "mixtral"}
    mbytes = write_gguf(fm, gguf_llama_meta(gm, MIXTRAL_LAYERS, E)
                        + gguf_sp_vocab(MIXTRAL["vocab_size"]),
                        gguf_llama_tensors(gm, MIXTRAL_LAYERS, E), seed + 2)
    log("gguf_file", model="mixtral", bytes=mbytes,
        write_s=round(time.perf_counter() - t0, 3), card=smi)
    family_yaml(models, "mixtral", fm.name,
                template={"use_tokenizer_template": True})
    cut = f"layers {MIXTRAL_LAYERS} of {MIXTRAL['num_hidden_layers']}"
    out["mixtral"] = gguf_leg(models, "mixtral", smi, MIXTRAL_LAYERS, fm,
                              chats, mixtral=True)
    out["mixtral"].update(layers=MIXTRAL_LAYERS, reduced=cut,
                          file_bytes=mbytes)
    shutil.rmtree(models, ignore_errors=True)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("gguf", card=smi, phase_s=out["phase_s"], **_leg_summary(out))
    return out


def gguf_leg(models: Path, key: str, smi: str, layers: int, path: Path,
             chats, int8: bool = False, lora: Path | None = None,
             mixtral: bool = False) -> dict:
    """One leg of phase gguf through ``serve_family``: every chat's prompt
    ids against encode(apply_chat_template(...), add_bos=True) with the
    file's tokenizer; on the plain leg the card's dequantization per
    type and the Q/K permutation, on the LoRA leg the merged leaf and a
    remove + apply on the running engine, on the Mixtral leg its MoE
    block."""
    bodies: list = []
    seen: list = []

    def on_load(backend):
        tk = type(backend.tokenizer).__name__
        if tk != "GGUFTokenizer":
            raise AssertionError(f"{key}: served by {tk}")
        bodies.extend(chats(backend))
        orig = backend._to_request

        def spy(opts):
            req = orig(opts)
            seen.append(list(req.prompt_ids))
            return req
        backend._to_request = spy
        return {"tokenizer": tk, "vocab": backend.tokenizer.vocab_size}

    def after(backend, res):
        del backend._to_request  # the class's method again
        eng, tk = backend.engine, backend.tokenizer
        for body in bodies:
            want = tk.encode(tk.apply_chat_template(
                body["messages"], add_generation_prompt=True), add_bos=True)
            if want not in seen:
                raise AssertionError(f"{key}: a chat's prompt ids are not "
                                     "encode(apply_chat_template(...))")
        done: dict = {"prompt_ids_equal": len(bodies)}
        if key == "llama31_8b":
            done["dequant_card_vs_cpu"] = gguf_card_dequant(path)
            done["qk_permutation"] = qk_permutation_check(eng, path,
                                                          GEOMETRY)
        if lora is not None:
            done["merged_leaf"] = lora_leaf_check(eng, path, lora,
                                                  GGUF_LORA_SCALE)
            text = LONG_PROMPT[:200]
            prompt, before = served_greedy(backend, text, 16)
            # layer 0 of each merged leaf before the round trip: the
            # unmerge subtracts the delta from the bf16 merged weight and
            # rounds again (as the JAX package's does), so remove + apply
            # need not give back the merged weights bitwise
            snap = {leaf: eng.params[leaf][0].clone()
                    for _, _, leaf in GGUF_LORA_PROJ}
            t0 = time.perf_counter()
            n_rm = backend.remove_lora(str(lora), GGUF_LORA_SCALE)
            rm_s = time.perf_counter() - t0
            removed = served_greedy(backend, text, 16)[1]
            t0 = time.perf_counter()
            n_ap = backend.apply_lora(str(lora), GGUF_LORA_SCALE)
            ap_s = time.perf_counter() - t0
            again = served_greedy(backend, text, 16)[1]
            drift = {}
            for leaf, w0 in snap.items():
                w1 = eng.params[leaf][0]
                drift[leaf] = {"elements_changed": int((w1 != w0).sum()),
                               "of": w0.numel(), "max_abs": float(
                                   (w1.float() - w0.float()).abs().max())}
            del snap
            done["hot"] = {"sites": [n_rm, n_ap], "remove_s": round(rm_s, 3),
                           "apply_s": round(ap_s, 3),
                           "ids_equal_after_reapply": again == before,
                           "ids_differ_without_adapter": removed != before,
                           "layer0_bitwise_after_reapply": not any(
                               d["elements_changed"] for d in drift.values()),
                           "layer0_drift": drift}
            if again != before:
                # how close the pick was: the logit deficit of the id
                # served before the round trip under the weights after it
                # (the dense forward), at the first step that differs
                d = next(i for i, (x, y) in enumerate(zip(before, again))
                         if x != y)
                ref = dense_deficits(eng, prompt, before, per_step=True)
                done["hot"].update(first_divergence=d,
                                   deficit_at_divergence=ref["deficits"][d],
                                   logit_tol=ref["tol"])
                log("gguf_lora_roundtrip", model=key, card=smi,
                    before=before, again=again, **done["hot"])
                raise AssertionError(f"{key}: ids after remove + apply "
                                     f"differ: {before} {again}")
        if mixtral:
            done["moe_block"] = moe_block_check(eng, layers // 2, seed=11)
        log("gguf_checks", model=key, card=smi, **done)
        return done

    res = serve_family(models, key, smi, lambda backend: bodies,
                       LONG_PROMPT, layers, True, int8=int8, tag="gguf",
                       on_load=on_load, after=after)
    long = res["burst"]["requests"][0]["prompt_tokens"]
    if long < 1024:
        raise AssertionError(f"{key}: the long chat has {long} tokens")
    return res


# ------------------------------------------------------------ phase 15

# published geometries (each checkpoint's config.json); random f32 weights
MINILM_L6 = {  # sentence-transformers/all-MiniLM-L6-v2
    "hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12,
    "intermediate_size": 1536, "vocab_size": 30522,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12}
BGE_LARGE = {  # BAAI/bge-large-en-v1.5
    "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
    "intermediate_size": 4096, "vocab_size": 30522,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12}
# cross-encoder/ms-marco-MiniLM-L-6-v2: MiniLM-L6 with a pooler and one
# label
CROSS_LABELS = 1
RETRIEVAL_TOL = 1e-4  # card against the port's CPU forward, f32 both
STORE_TOL = 1e-5  # similarities against a numpy f64 scan
STORE_ROWS, STORE_DIM, STORE_TOPK = 100_000, 384, 10
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
WORDPIECE_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
                      "[MASK]": 103}
# tokens (with [CLS] and [SEP]) of the 32 embedding inputs: every bucket
# (16, 64, 128, 256, 512), their edges, and three past 512 (cut there)
EMB_LENGTHS = (3, 5, 8, 12, 16, 17, 24, 30, 40, 48, 64, 65, 80, 100, 128,
               129, 150, 180, 200, 220, 256, 257, 300, 350, 400, 450, 480,
               511, 512, 513, 600, 700)
BGE_LENGTHS = (5, 16, 17, 64, 65, 128, 129, 256, 257, 400, 512, 600)


def wordpiece_vocab(vocab_size: int = 30522) -> list[str]:
    """A BERT-layout vocabulary: [PAD] 0, [unused*], [UNK] 100 - [MASK]
    103, more [unused*] to 998, single characters (printable ASCII, CJK)
    whole and as ``##`` pieces, then syllable words whole and as pieces."""
    vocab = [""] * 999
    for tok, i in WORDPIECE_SPECIALS.items():
        vocab[i] = tok
    n = 0
    for i in range(999):
        if not vocab[i]:
            vocab[i] = f"[unused{n}]"
            n += 1
    chars = ([chr(c) for c in range(33, 127) if not chr(c).isupper()]
             + [chr(c) for c in range(0x4E00, 0x4E00 + 400)])
    vocab += chars + ["##" + c for c in chars]
    cons, vows = "bcdfghjklmnprstvwz", "aeiou"
    syl = [c + v for c in cons for v in vows]
    seen = set(vocab)
    for words in (syl, [a + b for a in syl for b in syl],
                  [a + b + c for a in syl for b in syl[:40] for c in syl[:20]]):
        for w in words:
            for tok in (w, "##" + w):
                if tok not in seen and len(vocab) < vocab_size:
                    seen.add(tok)
                    vocab.append(tok)
    if len(vocab) != vocab_size:
        raise AssertionError(f"vocabulary of {len(vocab)}")
    return vocab


def vocab_words(vocab: list[str]) -> list[str]:
    """The vocabulary's whole words of two or more letters: each encodes
    to one id."""
    return [t for t in vocab[999:] if not t.startswith("##") and len(t) > 1]


def write_wordpiece_tokenizer(dirpath: Path, vocab_size: int = 30522
                              ) -> None:
    """BERT's ``tokenizer.json`` layout (BertNormalizer lowercasing,
    BertPreTokenizer, WordPiece, ``[CLS] $A [SEP]`` / ``[CLS] $A [SEP]
    $B:1 [SEP]:1``, WordPiece decoder) and its ``tokenizer_config.json``,
    written without ``tokenizers``."""
    vocab = wordpiece_vocab(vocab_size)
    specials = [{"id": i, "content": t, "single_word": False,
                 "lstrip": False, "rstrip": False, "normalized": False,
                 "special": True}
                for t, i in sorted(WORDPIECE_SPECIALS.items(),
                                   key=lambda kv: kv[1])]

    def special(tok, type_id):
        return {"SpecialToken": {"id": tok, "type_id": type_id}}

    def seq(name, type_id):
        return {"Sequence": {"id": name, "type_id": type_id}}

    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": specials,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0)],
            "pair": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0),
                     seq("B", 1), special("[SEP]", 1)],
            "special_tokens": {t: {"id": t, "ids": [WORDPIECE_SPECIALS[t]],
                                   "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100,
                  "vocab": {t: i for i, t in enumerate(vocab)}},
    }
    dirpath.mkdir(parents=True, exist_ok=True)
    (dirpath / "tokenizer.json").write_text(json.dumps(spec))
    (dirpath / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "BertTokenizer", "do_lower_case": True,
        "model_max_length": 512, "clean_up_tokenization_spaces": True,
        "unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
        "cls_token": "[CLS]", "mask_token": "[MASK]"}))


def bert_layout(g: dict, cross: bool) -> list[tuple[str, tuple]]:
    """(name, HF shape) of every tensor of a ``BertModel`` checkpoint (bare
    names, as sentence-transformers saves it) or of a
    ``BertForSequenceClassification`` one (``bert.`` prefix, a pooler and
    a classifier)."""
    D, F, V = g["hidden_size"], g["intermediate_size"], g["vocab_size"]
    p = "bert." if cross else ""
    out = [(p + "embeddings.word_embeddings.weight", (V, D)),
           (p + "embeddings.position_embeddings.weight",
            (g["max_position_embeddings"], D)),
           (p + "embeddings.token_type_embeddings.weight",
            (g["type_vocab_size"], D)),
           (p + "embeddings.LayerNorm.weight", (D,)),
           (p + "embeddings.LayerNorm.bias", (D,))]
    for i in range(g["num_hidden_layers"]):
        lp = f"{p}encoder.layer.{i}."
        for name, shape in (("attention.self.query", (D, D)),
                            ("attention.self.key", (D, D)),
                            ("attention.self.value", (D, D)),
                            ("attention.output.dense", (D, D)),
                            ("intermediate.dense", (F, D)),
                            ("output.dense", (D, F))):
            out += [(lp + name + ".weight", shape),
                    (lp + name + ".bias", (shape[0],))]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(lp + ln + ".weight", (D,)), (lp + ln + ".bias", (D,))]
    out += [(p + "pooler.dense.weight", (D, D)),
            (p + "pooler.dense.bias", (D,))]
    if cross:
        out += [("classifier.weight", (CROSS_LABELS, D)),
                ("classifier.bias", (CROSS_LABELS,))]
    return out


def write_bert_checkpoint(ckpt: Path, g: dict, seed: int, cross: bool,
                          vocab_size: int = 30522) -> tuple[int, float]:
    """A BERT checkpoint of geometry ``g`` with random f32 weights made on
    the card from ``seed`` (BERT's init: normal, std 0.02; LayerNorm
    weights near 1), its config.json and a WordPiece tokenizer. Returns
    (bytes, seconds)."""
    import math

    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    t0 = time.perf_counter()
    ckpt.mkdir(parents=True, exist_ok=True)
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = bert_layout(g, cross)
    shapes = [(n, torch.empty(s, dtype=torch.float32, device="meta"))
              for n, s in layout]

    def tensors():
        for name, shape in layout:
            w = torch.randn(shape, generator=gen, device=dev) * 0.02
            if name.endswith("LayerNorm.weight"):
                w = w + 1.0
            yield name, w

    save_iter(tensors(), str(ckpt / "model.safetensors"), shapes=shapes)
    config = {"architectures": ["BertForSequenceClassification" if cross
                                else "BertModel"],
              "model_type": "bert", "hidden_act": "gelu",
              "torch_dtype": "float32", **g,
              **({"num_labels": CROSS_LABELS} if cross else {})}
    (ckpt / "config.json").write_text(json.dumps(config, indent=1))
    write_wordpiece_tokenizer(ckpt, vocab_size)
    nbytes = sum(4 * math.prod(s) for _, s in layout)
    return nbytes, time.perf_counter() - t0


def words_text(words: list, n_tokens: int, rng) -> str:
    """A text of whole vocabulary words that encodes to ``n_tokens`` ids
    with [CLS] and [SEP]."""
    return " ".join(rng.choice(words, max(0, n_tokens - 2)).tolist())


def _cpu_worker(cls, model_dir: Path):
    """The port's worker on the CPU over the same directory: the
    reference forward."""
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions

    w = cls("cpu")
    res = w.load_model(ModelLoadOptions(model=str(model_dir)))
    if not res.success:
        raise AssertionError(f"CPU reference load: {res.message}")
    return w


def encode_bench(backend, buckets, smi: str) -> dict:
    """Device ms of one encode (batch 1, every position real) at each
    bucket: CUDA events over eager calls (what a request pays) and CUDA
    graph replay (device time alone)."""
    import torch

    out = {}
    for T in buckets:
        toks = torch.randint(1000, backend.spec.vocab_size, (1, T),
                             device=backend.device)
        mask = torch.ones(1, T, dtype=torch.int32, device=backend.device)
        iters = 10 if T >= 256 else 30
        out[T] = {"ms": _time_ms(lambda: backend.embed_ids(toks, mask),
                                 iters),
                  "graph_ms": _time_graph(
                      lambda: backend.embed_ids(toks, mask), iters)}
    return out


def encoder_flops(g: dict, T: int) -> int:
    """Multiply-adds x 2 of one T-token encode: the projections, the MLP
    and the two attention products per layer."""
    D, F, L = g["hidden_size"], g["intermediate_size"], g["num_hidden_layers"]
    return L * (2 * T * D * (4 * D + 2 * F) + 4 * T * T * D)


def embeddings_leg(port: int, app, name: str, ckpt: Path, texts: list,
                   g: dict, smi: str) -> dict:
    """``/v1/embeddings`` of ``texts`` on model ``name``: load s, wall,
    tokens/s, unit norms, the card against the port's CPU forward."""
    import numpy as np

    from localai_tfp_tpu_torch.workers.embeddings import \
        TorchEmbeddingsBackend

    t0 = time.perf_counter()
    status, _, raw = _req(port, "POST", "/v1/embeddings",
                          {"model": name, "input": texts[:1]})
    first_s = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"{name}: HTTP {status} {raw[:300]!r}")
    backend = app.loaded()[name]
    lm = app.model_loader.get(name)
    tk = backend.tokenizer
    n_tok = [min(len(tk.encode_special(t)), g["max_position_embeddings"])
             for t in texts]
    t0 = time.perf_counter()
    status, _, raw = _req(port, "POST", "/v1/embeddings",
                          {"model": name, "input": texts})
    wall = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"{name}: HTTP {status} {raw[:300]!r}")
    got = np.asarray([d["embedding"] for d in json.loads(raw)["data"]],
                     np.float32)
    if got.shape != (len(texts), g["hidden_size"]):
        raise AssertionError(f"{name}: embeddings of shape {got.shape}")
    norms = np.linalg.norm(got.astype(np.float64), axis=1)
    cpu = _cpu_worker(TorchEmbeddingsBackend, ckpt)
    want = np.concatenate([cpu.embed_batch([t]) for t in texts])
    err = float(np.abs(got - want).max())
    res = {"load_s": round(lm.load_s, 3),
           "load_and_first_request_s": round(first_s, 3),
           "texts": len(texts), "tokens": sum(n_tok),
           "tokens_min_max": [min(n_tok), max(n_tok)],
           "request_s": round(wall, 4),
           "tokens_per_s": round(sum(n_tok) / wall, 1),
           "max_abs_err_vs_cpu": err, "tol": RETRIEVAL_TOL,
           "norm_err": float(np.abs(norms - 1).max()), "card": smi}
    if not np.isfinite(got).all() or err > RETRIEVAL_TOL \
            or res["norm_err"] > 1e-5:
        raise AssertionError(f"{name}: {res}")
    return res


def rerank_leg(port: int, name: str, ckpt: Path, query: str, docs: list,
               cross: bool, smi: str) -> dict:
    """``/v1/rerank`` of ``docs`` on model ``name`` (top_n 5): scores
    within RETRIEVAL_TOL of the port's CPU forward, the order equal where
    neighbouring scores differ by more, usage equal to the tokenizer's
    count."""
    import numpy as np

    from localai_tfp_tpu_torch.workers.rerank import TorchRerankBackend

    body = {"model": name, "query": query, "documents": docs, "top_n": 5}
    _req(port, "POST", "/v1/rerank", {**body, "documents": docs[:1]})
    t0 = time.perf_counter()
    status, _, raw = _req(port, "POST", "/v1/rerank", body)
    wall = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"{name}: HTTP {status} {raw[:300]!r}")
    out = json.loads(raw)
    cpu = _cpu_worker(TorchRerankBackend, ckpt)
    ref = cpu.rerank(query, docs, len(docs))
    want = {d.index: d.relevance_score for d in ref.results}
    order = [d.index for d in ref.results]
    got = [(r["index"], r["relevance_score"]) for r in out["results"]]
    err = max(abs(s - want[i]) for i, s in got)
    swaps = [(r, i, order[r]) for r, (i, _) in enumerate(got)
             if i != order[r] and abs(want[i] - want[order[r]])
             > RETRIEVAL_TOL]
    tk = cpu.tokenizer
    n_tok = (sum(len(tk.encode_pair(query, d)[0]) for d in docs) if cross
             else sum(len(tk.encode_special(t)) for t in [query] + docs))
    res = {"mode": "cross-encoder" if cross else "bi-encoder cosine",
           "documents": len(docs), "top_n": len(got),
           "indices": [i for i, _ in got], "max_abs_err_vs_cpu": err,
           "tol": RETRIEVAL_TOL, "order_swaps_beyond_tol": swaps,
           "usage": out["usage"], "tokenizer_tokens": n_tok,
           "request_s": round(wall, 4), "card": smi}
    if (len(got) != 5 or err > RETRIEVAL_TOL or swaps
            or out["usage"]["total_tokens"] != n_tok):
        raise AssertionError(f"{name}: {res}")
    return res


def store_leg(port: int, app, smi: str, seed: int) -> dict:
    """100 000 unit-norm keys of width 384 (and a handful through
    ``/stores/set``) in the native store and in the Python store (its
    matvec on the card above 50 000 rows); finds of top 10 through the
    route against a numpy f64 scan; each find's ms, the Python store's
    split into the key copy and the matvec."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.store import backend as sb

    rng = np.random.default_rng(seed + 15)
    keys = rng.standard_normal((STORE_ROWS, STORE_DIM)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    few = rng.standard_normal((4, STORE_DIM)).astype(np.float32)
    few /= np.linalg.norm(few, axis=1, keepdims=True)
    values = [f"doc-{i}" for i in range(STORE_ROWS)]
    all_keys = np.concatenate([few, keys]).astype(np.float64)
    all_values = [f"few-{i}" for i in range(4)] + values
    saved = os.environ.get("LOCALAI_NATIVE_STORE")
    stores = {}
    try:
        for name, flag in (("store-native", "1"), ("store-python", "0")):
            os.environ["LOCALAI_NATIVE_STORE"] = flag
            st, _, raw = _req(port, "POST", "/stores/set", {
                "store": name, "keys": few.tolist(),
                "values": all_values[:4]})
            if st != 200:
                raise AssertionError(f"{name}: /stores/set {st} {raw!r}")
            backend = app.loaded()[name]
            t0 = time.perf_counter()
            backend.stores_set(keys, values)
            stores[name] = {"backend": backend,
                            "set_s": round(time.perf_counter() - t0, 3)}
    finally:
        if saved is None:
            os.environ.pop("LOCALAI_NATIVE_STORE", None)
        else:
            os.environ["LOCALAI_NATIVE_STORE"] = saved
    py = stores["store-python"]["backend"].store
    if not (isinstance(py, sb.VectorStore) and py.device.type == CARD
            and len(py) >= sb._DEVICE_THRESHOLD):
        raise AssertionError("the Python store does not scan on the card")
    if isinstance(stores["store-native"]["backend"].store, sb.VectorStore):
        raise AssertionError("the default store is not the native one")
    queries = [all_keys[7 + 1000 * i].astype(np.float32)
               + rng.standard_normal(STORE_DIM).astype(np.float32) * 0.05
               for i in range(5)]
    out = {"rows": len(all_values), "dim": STORE_DIM, "topk": STORE_TOPK}
    found = {}
    for name, s in stores.items():
        route_ms, direct_ms, errs = [], [], []
        for q in queries:
            dots = all_keys @ q.astype(np.float64)
            order = np.argsort(-dots)[:STORE_TOPK]
            t0 = time.perf_counter()
            st, _, raw = _req(port, "POST", "/stores/find", {
                "store": name, "key": q.tolist(), "topk": STORE_TOPK})
            route_ms.append((time.perf_counter() - t0) * 1e3)
            if st != 200:
                raise AssertionError(f"{name}: /stores/find {st} {raw!r}")
            res = json.loads(raw)
            if res["values"] != [all_values[i] for i in order]:
                raise AssertionError(f"{name}: find order {res['values']} "
                                     f"against {order.tolist()}")
            if np.asarray(res["keys"], np.float64).tolist() != \
                    all_keys[order].tolist():
                raise AssertionError(f"{name}: find keys differ")
            errs.append(float(np.abs(np.asarray(res["similarities"])
                                     - dots[order]).max()))
            found.setdefault(name, []).append(res)
            t0 = time.perf_counter()
            s["backend"].store.find(q, STORE_TOPK)
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"set_s": s["set_s"],
                     "find_route_ms": sorted(route_ms)[len(route_ms) // 2],
                     "find_ms": sorted(direct_ms)[len(direct_ms) // 2],
                     "max_abs_err_vs_f64": max(errs), "tol": STORE_TOL}
        if max(errs) > STORE_TOL:
            raise AssertionError(f"{name}: {out[name]}")
    for a, b in zip(found["store-native"], found["store-python"]):
        if a["keys"] != b["keys"] or a["values"] != b["values"]:
            raise AssertionError("native and Python stores disagree")
    # the Python store's find split: the whole key matrix to the card,
    # then the matvec (the host's top-k is the rest)
    dev = py.device
    host_keys, q = py._keys, queries[0]
    copy_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = torch.from_numpy(host_keys).to(dev)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    qd = torch.from_numpy(q).to(dev)
    from localai_tfp_tpu_torch.device import f32_products

    with f32_products():
        matvec_ms = _time_ms(lambda: k @ qd, 20)
    key_bytes = host_keys.nbytes
    out["store-python"].update(
        key_copy_ms=sorted(copy_ms)[2], key_bytes=key_bytes,
        key_copy_gb_per_s=round(key_bytes / sorted(copy_ms)[2] / 1e6, 2),
        matvec_ms=matvec_ms,
        matvec_bound_ms=key_bytes / HBM_BYTES_PER_S * 1e3)
    out["card"] = smi
    return out


def phase_retrieval(smi: str, seed: int) -> dict:
    """The retrieval surface on the card through the HTTP server: (a)
    all-MiniLM-L6-v2 embeddings, (b) bge-large-en-v1.5's geometry, its
    FLOP bound and the memory after its unload, (c) a cross-encoder and
    a bi-encoder through /v1/rerank, (d) the vector stores."""
    import shutil

    import numpy as np

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "retrieval"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    out = {}
    written = {}
    for key, g, cross in (("all-minilm-l6-v2", MINILM_L6, False),
                          ("ms-marco-minilm-l6", MINILM_L6, True),
                          ("bge-large-en-v1.5", BGE_LARGE, False)):
        nbytes, write_s = write_bert_checkpoint(models / key, g, seed, cross)
        written[key] = {"bytes": nbytes, "write_s": round(write_s, 3)}
    words = vocab_words(wordpiece_vocab())
    for name, backend, ckpt in (
            ("minilm", "sentencetransformers", "all-minilm-l6-v2"),
            ("bge-large", "sentencetransformers", "bge-large-en-v1.5"),
            ("ms-marco", "rerankers", "ms-marco-minilm-l6"),
            ("minilm-rerank", "rerankers", "all-minilm-l6-v2")):
        (models / f"{name}.yaml").write_text(
            f"name: {name}\nbackend: {backend}\n"
            f"parameters:\n  model: {ckpt}\n")
    log("retrieval_checkpoints", **written, card=smi)
    rng = np.random.default_rng(seed)
    texts = [words_text(words, n, rng) for n in EMB_LENGTHS]
    texts[1] = "北京 is the capital, 東京 too! " + texts[1]  # CJK, punctuation
    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        app = srv.app
        # (a) all-MiniLM-L6-v2 at full width and depth
        a = embeddings_leg(port, app, "minilm", models / "all-minilm-l6-v2",
                           texts, MINILM_L6, smi)
        a["device_ms_by_bucket"] = encode_bench(
            app.loaded()["minilm"], (16, 64, 128, 256, 512), smi)
        log("retrieval_a", model="sentence-transformers/all-MiniLM-L6-v2",
            **a)
        out["a"] = a
        # (b) bge-large-en-v1.5's geometry at full width and depth
        base = _mem()
        bge_texts = [words_text(words, n, rng) for n in BGE_LENGTHS]
        b = embeddings_leg(port, app, "bge-large",
                           models / "bge-large-en-v1.5", bge_texts,
                           BGE_LARGE, smi)
        loaded = _mem()
        bench = encode_bench(app.loaded()["bge-large"], (512,), smi)[512]
        flops = encoder_flops(BGE_LARGE, 512)
        b.update(encode_512_ms=bench["ms"], encode_512_graph_ms=
                 bench["graph_ms"], encode_512_flops=flops,
                 encode_512_bound_ms=flops / F32_FLOPS * 1e3,
                 bound_by="operations (f32, 67 TFLOP/s)",
                 allocated_loaded=loaded["allocated"] - base["allocated"])
        st, _, raw = _req(port, "POST", "/backend/shutdown",
                          {"model": "bge-large"})
        if st != 200:
            raise AssertionError(f"bge-large shutdown: {st} {raw!r}")
        after = _mem()
        b.update(allocated_base=base["allocated"],
                 allocated_after_unload=after["allocated"],
                 residue=_back("bge-large unload", after["allocated"], base))
        log("retrieval_b", model="BAAI/bge-large-en-v1.5 geometry", **b)
        out["b"] = b
        # (c) rerank: the cross-encoder, then MiniLM as a bi-encoder
        query = words_text(words, 12, rng)
        docs = [words_text(words, n, rng) for n in
                rng.integers(8, 200, 20).tolist()]
        docs[3] = query[:40] + " " + docs[3]  # one shares the query's words
        c = {"cross": rerank_leg(port, "ms-marco",
                                 models / "ms-marco-minilm-l6", query, docs,
                                 True, smi),
             "bi": rerank_leg(port, "minilm-rerank",
                              models / "all-minilm-l6-v2", query, docs,
                              False, smi)}
        log("retrieval_c", model="cross-encoder/ms-marco-MiniLM-L-6-v2 "
                                 "geometry; all-MiniLM-L6-v2", **c)
        out["c"] = c
        # (d) the vector stores
        d = store_leg(port, app, smi, seed)
        log("retrieval_d", **d)
        out["d"] = d
    finally:
        _shut(srv, th)
        shutil.rmtree(models, ignore_errors=True)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("retrieval", phase_s=out["phase_s"], card=smi)
    return out


# ------------------------------------------------------------ phase audio
#
# Whisper-large-v2 (openai/whisper-large-v2 config.json: d_model 1280, 32
# encoder and 32 decoder layers, 20 heads, ffn 5120, 80 mel bins, vocab
# 51865, 1500 source and 448 target positions; the widest Whisper the
# JAX package loads: large-v3's 128 mel bins do not fit its 80) with
# random f32 weights from the seed, and a silero-v5-geometry VAD, both
# behind the HTTP server.

WHISPER_LARGE_V2 = {"d_model": 1280, "encoder_layers": 32,
                    "decoder_layers": 32, "encoder_attention_heads": 20,
                    "decoder_attention_heads": 20, "encoder_ffn_dim": 5120,
                    "decoder_ffn_dim": 5120, "num_mel_bins": 80,
                    "vocab_size": 51865, "max_source_positions": 1500,
                    "max_target_positions": 448}
WHISPER_LANGS = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su").split()
# silero-vad v5 (16 kHz): a 256-sample STFT basis (129 bins), four k=3
# convs 129-128-64-64-128, an LSTM cell of 128, a 1-channel head
SILERO_V5 = {"win": 256, "enc": ((129, 128), (128, 64), (64, 64),
                                 (64, 128)), "hidden": 128}
WHISPER_TIE = 1e-3  # plain logits' top-two gap a served pick may lose by
ENC_TOL = 1e-4  # encoder by replay against eagerly (the same kernels)
VAD_TOL = 1e-4  # served VAD probabilities against the chunk loop
VAD_SECONDS = 60  # 1875 chunks of 512 samples
AUDIO_FORMATS = ("json", "verbose_json", "text")
# steps of the plain full-recompute decoder held to the served ids (each
# of the served decode's picks is also held to the plain decoder's
# teacher-forced logits)
PLAIN_STEPS = 64


def whisper_specials() -> list[str]:
    """Whisper's 1608 special tokens from id 50257: eot, sot, the 99
    languages, the task and control tokens, 1501 timestamps."""
    assert len(WHISPER_LANGS) == 99
    return (["<|endoftext|>", "<|startoftranscript|>"]
            + [f"<|{lang}|>" for lang in WHISPER_LANGS]
            + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
               "<|startofprev|>", "<|nocaptions|>", "<|notimestamps|>"]
            + [f"<|{i * 0.02:.2f}|>" for i in range(1501)])


def write_whisper_tokenizer(dirpath: Path) -> dict:
    """A byte-level BPE ``tokenizer.json`` in Whisper's layout, written
    like ``write_text_tokenizer``: 50257 byte and merged symbols, then
    Whisper's special tokens (eot 50257, sot 50258, ``<|en|>`` 50259, ...,
    ``<|notimestamps|>`` 50363, timestamps from 50364)."""
    specials = whisper_specials()
    vocab, merges = text_vocab(WHISPER_LARGE_V2["vocab_size"],
                               len(specials))
    n = len(vocab)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": n + k, "content": c, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for k, c in enumerate(specials)],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    (dirpath / "tokenizer.json").write_text(json.dumps(spec,
                                                       ensure_ascii=False))
    (dirpath / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
        "eos_token": "<|endoftext|>", "clean_up_tokenization_spaces": True,
    }, indent=1))
    return {"vocab": n + len(specials), "merges": len(merges)}


def whisper_layout(g: dict) -> list[tuple[str, tuple]]:
    """HF ``WhisperForConditionalGeneration`` tensor names and shapes
    (the head tied to ``embed_tokens``)."""
    D, F, M = g["d_model"], g["encoder_ffn_dim"], g["num_mel_bins"]
    out = [("model.encoder.conv1.weight", (D, M, 3)),
           ("model.encoder.conv1.bias", (D,)),
           ("model.encoder.conv2.weight", (D, D, 3)),
           ("model.encoder.conv2.bias", (D,)),
           ("model.encoder.embed_positions.weight",
            (g["max_source_positions"], D))]

    def attn(p: str, kind: str) -> list:
        rows = []
        for proj in ("q", "k", "v", "out"):
            rows.append((f"{p}{kind}.{proj}_proj.weight", (D, D)))
            if proj != "k":
                rows.append((f"{p}{kind}.{proj}_proj.bias", (D,)))
        return rows + [(f"{p}{kind}_layer_norm.weight", (D,)),
                       (f"{p}{kind}_layer_norm.bias", (D,))]

    def mlp(p: str) -> list:
        return [(f"{p}fc1.weight", (F, D)), (f"{p}fc1.bias", (F,)),
                (f"{p}fc2.weight", (D, F)), (f"{p}fc2.bias", (D,)),
                (f"{p}final_layer_norm.weight", (D,)),
                (f"{p}final_layer_norm.bias", (D,))]

    for i in range(g["encoder_layers"]):
        p = f"model.encoder.layers.{i}."
        out += attn(p, "self_attn") + mlp(p)
    out += [("model.encoder.layer_norm.weight", (D,)),
            ("model.encoder.layer_norm.bias", (D,)),
            ("model.decoder.embed_tokens.weight", (g["vocab_size"], D)),
            ("model.decoder.embed_positions.weight",
             (g["max_target_positions"], D))]
    for i in range(g["decoder_layers"]):
        p = f"model.decoder.layers.{i}."
        out += attn(p, "self_attn") + attn(p, "encoder_attn") + mlp(p)
    return out + [("model.decoder.layer_norm.weight", (D,)),
                  ("model.decoder.layer_norm.bias", (D,))]


def write_whisper_checkpoint(ckpt: Path, seed: int) -> tuple[int, float]:
    """Whisper-large-v2's geometry with random f32 weights made on the
    card from ``seed`` (matrices at 1/sqrt(fan-in), the token embedding
    at 0.02, biases small, LayerNorm weights near 1), its config.json and
    tokenizer. Returns (bytes, seconds)."""
    import math

    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    t0 = time.perf_counter()
    ckpt.mkdir(parents=True, exist_ok=True)
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = whisper_layout(WHISPER_LARGE_V2)
    shapes = [(n, torch.empty(s, dtype=torch.float32, device="meta"))
              for n, s in layout]

    def tensors():
        for name, shape in layout:
            w = torch.randn(shape, generator=gen, device=dev)
            if "layer_norm.weight" in name:
                w = 1.0 + 0.05 * w
            elif len(shape) == 1:
                w = 0.02 * w
            elif name.endswith(("embed_tokens.weight",
                                "embed_positions.weight")):
                w = 0.02 * w
            else:
                w = w * math.prod(shape[1:]) ** -0.5
            yield name, w

    save_iter(tensors(), str(ckpt / "model.safetensors"), shapes=shapes)
    (ckpt / "config.json").write_text(json.dumps({
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper", "torch_dtype": "float32",
        "decoder_start_token_id": 50258, "eos_token_id": 50257,
        "pad_token_id": 50257, "bos_token_id": 50257,
        **WHISPER_LARGE_V2}, indent=1))
    write_whisper_tokenizer(ckpt)
    nbytes = sum(4 * math.prod(s) for _, s in layout)
    return nbytes, time.perf_counter() - t0


def voiced(seconds: float, sr: int, seed: int) -> "np.ndarray":
    """Speech-like audio at ``sr``: low noise with voiced bursts (five
    harmonics of a pitch of 100-220 Hz) of 0.3-1.2 s, 0.3-0.9 s apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = rng.standard_normal(n) * 0.003
    t = 0.2
    while t < seconds - 0.4:
        dur = float(rng.uniform(0.3, 1.2))
        a, b = int(t * sr), min(n, int((t + dur) * sr))
        tt = np.arange(b - a) / sr
        f0 = float(rng.uniform(100, 220))
        x[a:b] += sum(0.3 / k * np.sin(2 * np.pi * k * f0 * tt)
                      for k in range(1, 6))
        t += dur + float(rng.uniform(0.3, 0.9))
    return x.astype(np.float32)


def write_wav16(f, pcm, sr: int) -> None:
    """[n] or [n, channels] float PCM -> a 16-bit WAV written to the file
    object ``f``."""
    import wave

    import numpy as np

    x = np.asarray(pcm, np.float64)
    ch = 1 if x.ndim == 1 else x.shape[1]
    raw = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    with wave.open(f, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(raw)


def multipart_body(fields: dict, filename: str, data: bytes) -> tuple:
    """(body, content type) of a form with ``fields`` and one ``file``."""
    import uuid

    b = uuid.uuid4().hex
    out = b""
    for k, v in fields.items():
        out += (f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\""
                f"\r\n\r\n{v}\r\n").encode()
    out += (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: audio/wav\r\n\r\n"
            ).encode() + data + f"\r\n--{b}--\r\n".encode()
    return out, f"multipart/form-data; boundary={b}"


def _post_raw(port: int, path: str, body: bytes, ctype: str,
              timeout: float = 600.0) -> tuple:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=body, headers={"Content-Type": ctype})
        r = c.getresponse()
        return r.status, r.getheader("Content-Type", ""), r.read()
    finally:
        c.close()


def transcribe_leg(port: int, name: str, wav: bytes, seconds: float,
                   chunks: int, fields: dict,
                   formats: tuple = AUDIO_FORMATS) -> dict:
    """``wav`` through ``/v1/audio/transcriptions`` in each of
    ``formats`` (verbose_json among them): 200s, one segment a 30 s chunk
    ending at the audio's end, tokens in every segment, the text the
    segments' texts joined, the same text in every format (greedy);
    each request's wall ms and real-time factor. Returns (the result
    line, each segment's tokens)."""
    out = {"audio_s": seconds, "formats": {}}
    texts = set()
    for fmt in formats:
        body, ctype = multipart_body({"model": name, "response_format": fmt,
                                      **fields}, "speech.wav", wav)
        t0 = time.perf_counter()
        status, ct, raw = _post_raw(port, "/v1/audio/transcriptions", body,
                                    ctype)
        wall = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise AssertionError(f"{name} {fmt}: HTTP {status} {raw[:300]!r}")
        if fmt == "text":
            if not ct.startswith("text/plain"):
                raise AssertionError(f"{name} text: content type {ct}")
            texts.add(raw.decode())
        else:
            res = json.loads(raw)
            texts.add(res["text"])
            if fmt == "verbose_json":
                segs = res["segments"]
                ends = [s["end"] for s in segs]
                want_ends = [min(30.0 * (i + 1), seconds)
                             for i in range(chunks)]
                if (len(segs) != chunks or
                        max(abs(a - b) for a, b in zip(ends, want_ends))
                        > 1e-3 or abs(res["duration"] - seconds) > 1e-3
                        or not all(s["tokens"] for s in segs)
                        or res["text"] != " ".join(
                            s["text"] for s in segs if s["text"]).strip()):
                    raise AssertionError(f"{name}: segments {segs}")
                out["segments"] = [{k: s[k] for k in ("id", "start", "end")}
                                   | {"tokens": len(s["tokens"]),
                                      "text_chars": len(s["text"])}
                                   for s in segs]
                tokens = [s["tokens"] for s in segs]
        out["formats"][fmt] = {"wall_ms": round(wall, 3),
                               "real_time_factor": round(
                                   wall / 1e3 / seconds, 5)}
    if len(texts) != 1:
        raise AssertionError(f"{name}: formats gave other texts {texts}")
    out["text_chars"] = len(texts.pop())
    return out, tokens


def whisper_decode_check(backend, mel, prompt: list, max_new: int) -> tuple:
    """The served decoder (replays, ``max_new`` steps) against the plain
    full-recompute decoder on the card (its first PLAIN_STEPS): ids
    equal, or every served pick within WHISPER_TIE of the argmax of the
    plain decoder's teacher-forced logits over prompt + the served ids
    (the ``dense_deficits`` criterion at f32), which every one of the
    ``max_new`` picks must meet; each decoder's wall ms. Returns (the
    result, the served ids)."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models import whisper as tw

    spec, params, run = backend.spec, backend.params, backend.runner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = run.transcribe(mel, max_new, prompt)
    served_ms = (time.perf_counter() - t0) * 1e3
    m = torch.from_numpy(mel)[None].to(backend.device)
    steps = min(PLAIN_STEPS, max_new)
    t0 = time.perf_counter()
    plain = tw.greedy_transcribe(spec, params, m, steps,
                                 torch.tensor(prompt)).cpu().numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    enc = tw.encode_audio(spec, params, m)
    n = (served.tolist() + [spec.eot]).index(spec.eot)  # picks before eot
    seq = torch.tensor([prompt + served[:max(n - 1, 0)].tolist()],
                       device=backend.device)
    with torch.inference_mode():
        rows = tw.decode_logits(spec, params, seq, enc)[0, len(prompt) - 1:]
    tok = torch.from_numpy(served[:n]).to(backend.device)
    deficit = (rows.max(-1).values - rows.gather(-1, tok[:, None])[:, 0])
    same = int(np.argmax(np.append(plain != served[:steps], True)))
    res = {"max_new": max_new, "picks": n, "plain_steps": steps,
           "ids_equal_plain": bool((plain == served[:steps]).all()),
           "first_difference": None if same == steps else same,
           "worst_logit_deficit": float(deficit.max()) if n else 0.0,
           "exact_argmax": int((deficit == 0).sum()),
           "tie_tol": WHISPER_TIE, "logit_std": float(rows.std()),
           "served_ms": round(served_ms, 3), "plain_ms": round(plain_ms, 3)}
    if not res["ids_equal_plain"] and not (
            res["worst_logit_deficit"] <= WHISPER_TIE
            and bool(torch.isfinite(rows).all())):
        raise AssertionError(f"whisper decode: {res}")
    return res, served


def whisper_timings(backend, mel, prompt: list) -> dict:
    """Encoder device ms a chunk by replay and eagerly (CUDA events);
    decoder host ms a token by replay (64 decode steps after the prompt)
    and eagerly (32), the host clock around a synchronize; encoder
    replay against the eager encoder."""
    import torch

    from localai_tfp_tpu_torch.models import whisper as tw

    spec, params, run = backend.spec, backend.params, backend.runner
    m = torch.from_numpy(mel)[None].to(backend.device)
    enc_replay = run.encode(mel).clone()
    enc_eager = tw.encode_audio(spec, params, m)
    err = float((enc_replay - enc_eager).abs().max())
    if not err <= ENC_TOL:
        raise AssertionError(f"encoder replay vs eager: {err}")
    run.set_mel(mel)
    enc_ms = _time_ms(lambda: run._run("encode"), 10)
    enc_eager_ms = _time_ms(lambda: tw.encode_audio(spec, params, m), 5)

    def per_token(eager: bool) -> float:
        run.eager = eager
        try:
            run._run("encode")
            run._reset()
            for t in prompt:
                run.tok.fill_(t)
                run._run("feed")
            torch.cuda.synchronize()
            blocks = 1 if eager else 2
            t0 = time.perf_counter()
            for _ in range(blocks):
                run.at.zero_()
                for _ in range(32):
                    run._run("decode")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / (32 * blocks)
        finally:
            run.eager = False

    replay_ms = [per_token(False) for _ in range(2)][-1]
    eager_ms = per_token(True)
    return {"encoder_device_ms": enc_ms, "encoder_eager_device_ms":
            enc_eager_ms, "encoder_replay_vs_eager_max_abs_err": err,
            "encoder_replay_bitwise": bool(torch.equal(enc_replay,
                                                        enc_eager)),
            "encoder_tol": ENC_TOL, "decode_host_ms_per_token": replay_ms,
            "decode_eager_host_ms_per_token": eager_ms}


def silero_state_dict(seed: int, audio) -> dict:
    """silero-v5-geometry weights in its key schema, random from
    ``seed`` on the card; the head's weight scaled and its bias set so
    that the logits of ``audio``'s voiced chunks average +3 and those of
    its quiet chunks -3 (the probabilities then cross both of the
    route's thresholds, and its segments follow the voiced bursts)."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models import vad_net as tv

    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(seed)
    W, H = SILERO_V5["win"], SILERO_V5["hidden"]

    def t(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    sd = {"_model.stft.forward_basis_buffer": t(W + 2, 1, W,
                                                 scale=W ** -0.5)}
    for i, (cin, cout) in enumerate(SILERO_V5["enc"]):
        sd[f"_model.encoder.{i}.reparam_conv.weight"] = t(
            cout, cin, 3, scale=(3 * cin) ** -0.5)
        sd[f"_model.encoder.{i}.reparam_conv.bias"] = t(cout, scale=0.02)
    for k in ("weight_ih", "weight_hh"):
        sd[f"_model.decoder.rnn.{k}"] = t(4 * H, H, scale=H ** -0.5)
    for k in ("bias_ih", "bias_hh"):
        sd[f"_model.decoder.rnn.{k}"] = t(4 * H, scale=0.02)
    sd["_model.decoder.decoder.2.weight"] = t(1, H, 1, scale=1.0)
    sd["_model.decoder.decoder.2.bias"] = torch.zeros(1, device=dev)
    p = np.clip(tv.speech_probs(tv.load_state_dict(sd, dev), audio),
                1e-6, 1 - 1e-6)
    z = np.log(p / (1 - p))  # the head's logit with no bias: linear in it
    rms = np.sqrt((audio[:len(z) * tv.CHUNK].reshape(len(z), -1)
                   .astype(np.float64) ** 2).mean(1))
    loud = rms > 10 * np.percentile(rms, 5)  # the noise floor: 0.003
    zv, zq = float(z[loud].mean()), float(z[~loud].mean())
    if not loud.any() or loud.all() or abs(zv - zq) < 1e-6:
        raise AssertionError(f"vad weights: voiced {zv}, quiet {zq}, "
                             f"{int(loud.sum())} loud chunks")
    scale = 6.0 / (zv - zq)
    sd["_model.decoder.decoder.2.weight"] *= scale
    sd["_model.decoder.decoder.2.bias"] += -scale * (zv + zq) / 2
    return {k: v.cpu() for k, v in sd.items()}


def vad_leg(port: int, app, name: str, audio, smi: str) -> dict:
    """``/v1/vad`` over ``audio`` (1875 chunks): the route's segments
    equal to the segmentation of the served probabilities; the served
    probabilities (the batched front end, one replay a block of LSTM
    steps) within VAD_TOL of the chunk-by-chunk loop; each one's ms."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models import vad_net as tv

    # 4 decimals of a float64: ~8 bytes a sample, 7.7 MB of JSON under
    # the 15 MiB upload limit
    body = {"model": name,
            "audio": np.round(audio.astype(np.float64), 4).tolist()}
    pcm = np.asarray(body["audio"], np.float32)
    t0 = time.perf_counter()
    status, _, raw = _req(port, "POST", "/v1/vad", body)
    first_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"vad: HTTP {status} {raw[:300]!r}")
    t0 = time.perf_counter()
    status, _, raw = _req(port, "POST", "/v1/vad", body)
    wall_ms = (time.perf_counter() - t0) * 1e3
    segs = json.loads(raw)["segments"]
    backend = app.loaded()[name]
    run = backend.runner
    replays = run.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = run.probabilities(pcm)
    served_ms = (time.perf_counter() - t0) * 1e3
    replays = run.replays - replays
    t0 = time.perf_counter()
    loop = tv.speech_probs(run.params, pcm)
    loop_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(served - loop).max())
    want = [{"start": round(s, 3), "end": round(e, 3)}
            for s, e in tv.probs_to_segments(
                served, threshold=0.5, min_speech_s=backend.min_speech_s,
                min_silence_s=backend.min_silence_s)]
    res = {"chunks": int(len(served)), "segments": len(segs),
           "replays": replays, "request_first_ms": round(first_ms, 3),
           "request_ms": round(wall_ms, 3), "served_ms": round(served_ms, 3),
           "chunk_loop_ms": round(loop_ms, 3), "max_abs_err_vs_loop": err,
           "tol": VAD_TOL, "card": smi}
    # the probabilities cross the entry (0.5) and exit (0.35) thresholds,
    # so the hysteresis opens and closes segments
    res["chunks_above_0_5"] = int((served >= 0.5).sum())
    res["chunks_below_0_35"] = int((served < 0.35).sum())
    blocks = 0 if run.eager else -(-len(served) // tv.BLOCK)
    if (len(served) != VAD_SECONDS * 16000 // 512 or err > VAD_TOL
            or segs != want or len(segs) < 2 or replays != blocks
            or not res["chunks_above_0_5"] or not res["chunks_below_0_35"]):
        raise AssertionError(f"vad: {res} {segs[:4]} {want[:4]}")
    return res


def phase_audio(smi: str, seed: int) -> dict:
    """Audio in through the HTTP server: Whisper-large-v2's geometry
    (random f32 weights, 6.2 GB) behind ``backend: whisper`` transcribing
    a 12 s 16 kHz mono WAV and a 45 s 44.1 kHz stereo one (two chunks,
    resampled) in every response format; the served decoder against the
    plain one and the encoder by replay against eagerly; a
    silero-v5-geometry VAD behind ``backend: silero-vad`` over 60 s."""
    import io
    import shutil

    import numpy as np

    from localai_tfp_tpu_torch.models import whisper as tw
    from localai_tfp_tpu_torch.models.safetensors_io import save_file
    from localai_tfp_tpu_torch.workers.whisper import load_pcm

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "audio"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    nbytes, write_s = write_whisper_checkpoint(models / "whisper-large-v2",
                                               seed)
    vad_audio = voiced(VAD_SECONDS, 16000, seed + 2)
    save_file(silero_state_dict(seed, vad_audio),
              str(models / "silero_vad.safetensors"))
    (models / "whisper.yaml").write_text(
        "name: whisper\nbackend: whisper\nparameters:\n"
        "  model: whisper-large-v2\n")
    (models / "vad.yaml").write_text(
        "name: vad\nbackend: silero-vad\nparameters:\n"
        "  model: silero_vad.safetensors\n")
    log("audio_checkpoint", model="openai/whisper-large-v2 geometry",
        bytes=nbytes, write_s=round(write_s, 3), card=smi)
    wavs = {}
    short = voiced(12.0, 16000, seed)
    buf = io.BytesIO()
    write_wav16(buf, short, 16000)
    wavs["short"] = buf.getvalue()
    left = voiced(45.0, 44100, seed + 1)
    buf = io.BytesIO()
    write_wav16(buf, np.stack([left, 0.5 * left], -1), 44100)
    wavs["long"] = buf.getvalue()
    out = {"checkpoint_bytes": nbytes}
    srv, th = _serve(models)
    try:
        port = srv.server_address[1]
        app = srv.app
        out["short"], short_tokens = transcribe_leg(
            port, "whisper", wavs["short"], 12.0, 1, {})
        # the formats render one result whatever its chunks: the two-chunk
        # file goes once, where its segments are checked
        lm = app.model_loader.get("whisper")
        backend = lm.backend
        out["load_s"] = round(lm.load_s, 3)
        out["graph_pool_bytes"] = backend.runner.pool_bytes
        out["long"], _ = transcribe_leg(
            port, "whisper", wavs["long"], 45.0, 2,
            {"language": "de", "translate": "true"}, ("verbose_json",))
        log("audio_transcriptions", short=out["short"], long=out["long"],
            load_s=out["load_s"], graph_pool_bytes=out["graph_pool_bytes"],
            card=smi)
        # the served decoder against the plain one on the short file
        path = models / "short.wav"
        path.write_bytes(wavs["short"])
        pcm = load_pcm(str(path))
        t0 = time.perf_counter()
        for _ in range(5):
            mel = tw.log_mel_spectrogram(pcm)
        mel_ms = (time.perf_counter() - t0) * 1e3 / 5
        prompt = backend._prompt("", False)
        max_new = min(backend.MAX_NEW, backend.spec.max_target
                      - len(prompt) - 1)
        dec, served = whisper_decode_check(backend, mel, prompt, max_new)
        if short_tokens[0] != served[:dec["picks"]].tolist():
            raise AssertionError("whisper: the route's tokens differ from "
                                 "the runner's")
        tm = whisper_timings(backend, mel, prompt)
        out["decode"] = dec
        out["timing"] = {**tm, "host_log_mel_ms_per_chunk": round(mel_ms, 3)}
        log("audio_whisper", decode=dec, **out["timing"], card=smi)
        out["vad"] = vad_leg(port, app, "vad", vad_audio, smi)
        log("audio_vad", model="silero-vad v5 geometry (16 kHz)",
            **out["vad"])
    finally:
        _shut(srv, th)
        shutil.rmtree(models, ignore_errors=True)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("audio", phase_s=out["phase_s"], card=smi)
    return out


# ----------------------------------------------------------- phase tts

# facebook/mms-tts-eng's published config.json (models/vits.py's VitsSpec
# defaults): the inference widths; its 38-symbol character vocabulary
MMS_TTS_ENG = {
    "model_type": "vits", "vocab_size": 38, "hidden_size": 192,
    "num_hidden_layers": 6, "num_attention_heads": 2, "window_size": 4,
    "ffn_dim": 768, "ffn_kernel_size": 3, "flow_size": 192,
    "spectrogram_bins": 513, "upsample_initial_channel": 512,
    "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "leaky_relu_slope": 0.1, "depth_separable_channels": 2,
    "depth_separable_num_layers": 3, "duration_predictor_flow_bins": 10,
    "duration_predictor_tail_bound": 5.0,
    "duration_predictor_kernel_size": 3, "duration_predictor_num_flows": 4,
    "prior_encoder_num_flows": 4, "prior_encoder_num_wavenet_layers": 4,
    "wavenet_kernel_size": 5, "wavenet_dilation_rate": 1,
    "noise_scale": 0.667, "noise_scale_duration": 0.8, "speaking_rate": 1.0,
    "sampling_rate": 16000,
}
MMS_VOCAB = list("_ abcdefghijklmnopqrstuvwxyz'-0123456789")[:38]
# jaywalnut310/vits configs/ljs_base.json's model (piper's medium voices):
# MMS's widths, 178 symbols, 22050 Hz, one speaker
LJS_BASE = {**MMS_TTS_ENG, "vocab_size": 178, "sampling_rate": 22050}
# hexgrad/Kokoro-82M's config.json (models/kokoro.py's KokoroSpec defaults)
KOKORO_82M = {
    "istftnet": {"upsample_kernel_sizes": [20, 12], "upsample_rates": [10, 6],
                 "gen_istft_hop_size": 5, "gen_istft_n_fft": 20,
                 "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                 "resblock_kernel_sizes": [3, 7, 11],
                 "upsample_initial_channel": 512},
    "dim_in": 64, "dropout": 0.2, "hidden_dim": 512, "max_conv_dim": 512,
    "max_dur": 50, "multispeaker": True, "n_layer": 3, "n_mels": 80,
    "n_token": 178, "style_dim": 128, "text_encoder_kernel_size": 5,
    "plbert": {"hidden_size": 768, "num_attention_heads": 12,
               "intermediate_size": 2048, "max_position_embeddings": 512,
               "num_hidden_layers": 12, "dropout": 0.1},
}
KOKORO_VOICE_ROWS = 510  # a voice pack's rows (one per token count)
KOKORO_DUR_BIAS = -2.0  # duration_proj's bias: ~6 frames a token
# OuteTTS-0.2-500M's LM: Qwen2.5-0.5B's config.json
QWEN25_05B = {
    "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
    "hidden_size": 896, "intermediate_size": 4864,
    "num_attention_heads": 14, "num_key_value_heads": 2,
    "num_hidden_layers": 24, "vocab_size": 151936,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "tie_word_embeddings": True,
    "use_sliding_window": False, "sliding_window": 32768,
    "max_window_layers": 21, "bos_token_id": 151643,
    "eos_token_id": 151643, "torch_dtype": "bfloat16",
}
# facebook/encodec_24khz's config.json (the decoder OuteTTS's codes go
# through in the JAX package; OuteTTS-0.2 itself ships a WavTokenizer)
ENCODEC_24KHZ = {
    "model_type": "encodec", "sampling_rate": 24000, "audio_channels": 1,
    "num_filters": 32, "upsampling_ratios": [8, 5, 4, 2],
    "hidden_size": 128, "codebook_size": 1024, "codebook_dim": 128,
    "num_lstm_layers": 2, "kernel_size": 7, "last_kernel_size": 7,
    "residual_kernel_size": 3, "dilation_growth_rate": 2,
    "num_residual_layers": 1, "compress": 2,
    "target_bandwidths": [1.5, 3.0, 6.0, 12.0, 24.0],
    "norm_type": "weight_norm", "use_causal_conv": True, "pad_mode": "reflect",
}
OUTE_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>",
                 "<|text_start|>", "<|text_end|>", "<|audio_start|>",
                 "<|audio_end|>"]
OUTE_CODE_SCALE = 16  # the tied head's code rows against the others: a
# random LM then emits codes, as a trained one does after <|audio_start|>
OUTE_GREEDY_TOKENS = 64
TTS_TEXT = "The quick brown fox jumps over the lazy dog."
TTS_TOL = 1e-3  # card against CPU, of max|CPU waveform|; f32, TF32 off
TTS_LSB = 1  # served int16 samples against the card's own waveform


def vits_layout(c: dict) -> list[tuple[str, tuple]]:
    """(HF name, shape) of every tensor ``models/vits.py`` reads from an
    HF VitsModel checkpoint of config ``c`` (the posterior encoder,
    training only, is not written); the WaveNet convolutions weight-normed
    (``original0`` [O, 1, 1], ``original1``)."""
    H, F, V = c["hidden_size"], c["ffn_dim"], c["vocab_size"]
    k, fl = c["ffn_kernel_size"], c["flow_size"]
    dh = H // c["num_attention_heads"]
    w, dk, bins = c["window_size"], c["duration_predictor_kernel_size"], \
        c["duration_predictor_flow_bins"]
    out = [("text_encoder.embed_tokens.weight", (V, H)),
           ("text_encoder.project.weight", (2 * fl, H, 1)),
           ("text_encoder.project.bias", (2 * fl,))]
    for i in range(c["num_hidden_layers"]):
        lp = f"text_encoder.encoder.layers.{i}."
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(lp + f"attention.{p}.weight", (H, H)),
                    (lp + f"attention.{p}.bias", (H,))]
        out += [(lp + "attention.emb_rel_k", (1, 2 * w + 1, dh)),
                (lp + "attention.emb_rel_v", (1, 2 * w + 1, dh)),
                (lp + "layer_norm.weight", (H,)), (lp + "layer_norm.bias", (H,)),
                (lp + "feed_forward.conv_1.weight", (F, H, k)),
                (lp + "feed_forward.conv_1.bias", (F,)),
                (lp + "feed_forward.conv_2.weight", (H, F, k)),
                (lp + "feed_forward.conv_2.bias", (H,)),
                (lp + "final_layer_norm.weight", (H,)),
                (lp + "final_layer_norm.bias", (H,))]

    def dds(prefix):
        rows = []
        for i in range(c["depth_separable_num_layers"]):
            rows += [(f"{prefix}.convs_dilated.{i}.weight", (H, 1, dk)),
                     (f"{prefix}.convs_dilated.{i}.bias", (H,)),
                     (f"{prefix}.convs_pointwise.{i}.weight", (H, H, 1)),
                     (f"{prefix}.convs_pointwise.{i}.bias", (H,))]
            for n in ("norms_1", "norms_2"):
                rows += [(f"{prefix}.{n}.{i}.weight", (H,)),
                         (f"{prefix}.{n}.{i}.bias", (H,))]
        return rows

    dp = "duration_predictor"
    half = c["depth_separable_channels"] // 2
    out += [(f"{dp}.conv_pre.weight", (H, H, 1)), (f"{dp}.conv_pre.bias", (H,)),
            (f"{dp}.conv_proj.weight", (H, H, 1)),
            (f"{dp}.conv_proj.bias", (H,))] + dds(f"{dp}.conv_dds")
    out += [(f"{dp}.flows.0.translate", (2 * half, 1)),
            (f"{dp}.flows.0.log_scale", (2 * half, 1))]
    for i in range(1, c["duration_predictor_num_flows"] + 1):
        fp = f"{dp}.flows.{i}"
        out += [(f"{fp}.conv_pre.weight", (H, half, 1)),
                (f"{fp}.conv_pre.bias", (H,)),
                (f"{fp}.conv_proj.weight", (half * (3 * bins - 1), H, 1)),
                (f"{fp}.conv_proj.bias", (half * (3 * bins - 1),))]
        out += dds(f"{fp}.conv_dds")
    wk, n_wn = c["wavenet_kernel_size"], c["prior_encoder_num_wavenet_layers"]
    for i in range(c["prior_encoder_num_flows"]):
        fp = f"flow.flows.{i}"
        out += [(f"{fp}.conv_pre.weight", (H, fl // 2, 1)),
                (f"{fp}.conv_pre.bias", (H,)),
                (f"{fp}.conv_post.weight", (fl // 2, H, 1)),
                (f"{fp}.conv_post.bias", (fl // 2,))]
        for j in range(n_wn):
            rs = 2 * H if j < n_wn - 1 else H
            for name, o, ii, kk in (("in_layers", 2 * H, H, wk),
                                    ("res_skip_layers", rs, H, 1)):
                wp = f"{fp}.wavenet.{name}.{j}"
                out += [(f"{wp}.parametrizations.weight.original0", (o, 1, 1)),
                        (f"{wp}.parametrizations.weight.original1",
                         (o, ii, kk)), (f"{wp}.bias", (o,))]
    ch = c["upsample_initial_channel"]
    out += [("decoder.conv_pre.weight", (ch, fl, 7)),
            ("decoder.conv_pre.bias", (ch,))]
    n_k = len(c["resblock_kernel_sizes"])
    for i, kk in enumerate(c["upsample_kernel_sizes"]):
        out += [(f"decoder.upsampler.{i}.weight", (ch, ch // 2, kk)),
                (f"decoder.upsampler.{i}.bias", (ch // 2,))]
        ch //= 2
        for j, rk in enumerate(c["resblock_kernel_sizes"]):
            rp = f"decoder.resblocks.{i * n_k + j}"
            for m in range(len(c["resblock_dilation_sizes"][j])):
                for conv in ("convs1", "convs2"):
                    out += [(f"{rp}.{conv}.{m}.weight", (ch, ch, rk)),
                            (f"{rp}.{conv}.{m}.bias", (ch,))]
    out.append(("decoder.conv_post.weight", (1, ch, 7)))
    return out


def vits_tensor(name: str, shape: tuple, gen) -> "torch.Tensor":
    """One random VITS tensor: norms 1, biases and the duration affine 0,
    relative embeddings and the character embedding as HF draws them,
    matrices at 0.5 / sqrt(fan-in), except the duration flows' spline
    projections at 0.02 (near-identity splines: a few frames a symbol),
    and each weight norm's magnitude the norm of its direction (the
    folded weight is the direction)."""
    import torch

    if name.endswith(("translate", "log_scale", ".bias")):
        return torch.zeros(shape)
    if len(shape) == 1:
        return torch.ones(shape)
    w = torch.randn(shape, generator=gen)
    if "emb_rel" in name:
        return w * shape[-1] ** -0.5
    if name.endswith("embed_tokens.weight"):
        return w * shape[1] ** -0.5
    if name.endswith("original0"):
        return w  # replaced by the direction's norm in write_vits
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    if name.startswith("decoder.upsampler"):
        fan_in = shape[0] * shape[2] // 2
    if "duration_predictor.flows" in name and "conv_proj" in name:
        return w * 0.02
    return w * 0.5 * fan_in ** -0.5


def write_vits(layout: list, seed: int) -> dict:
    """{name: f32 tensor} of ``layout``, on the host, from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {n: vits_tensor(n, s, gen) for n, s in layout}
    for n in sd:
        if n.endswith("original0"):
            v = sd[n[:-1] + "1"]
            sd[n] = v.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    return sd


def write_mms_dir(d: Path, seed: int) -> int:
    """facebook/mms-tts-eng's geometry as an HF VITS directory: config,
    safetensors, ``vocab.json`` and the tokenizer config (pad = the blank,
    no phonemizer). Returns the parameter bytes."""
    from localai_tfp_tpu_torch.models.safetensors_io import save_file

    d.mkdir(parents=True)
    sd = write_vits(vits_layout(MMS_TTS_ENG), seed)
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(MMS_TTS_ENG, indent=1))
    (d / "vocab.json").write_text(json.dumps(
        {c: i for i, c in enumerate(MMS_VOCAB)}))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "VitsTokenizer", "add_blank": True,
        "normalize": True, "phonemize": False, "language": "eng",
        "pad_token": MMS_VOCAB[0], "unk_token": "<unk>"}))
    return sum(t.numel() * 4 for t in sd.values())


def _onnx_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _onnx_ld(field: int, payload: bytes) -> bytes:
    return _onnx_varint((field << 3) | 2) + _onnx_varint(len(payload)) \
        + payload


def write_piper_voice_files(d: Path, seed: int) -> int:
    """A piper voice at ljs_base's widths: the HF-named VITS tensors
    under their original-VITS names (``models/piper.py``'s shim), weight
    norm fused and attention projections as 1x1 convolutions as
    torch.onnx.export leaves them, in an ONNX ModelProto's initializers;
    the sidecar json with a phoneme id map over the fallback
    phonemizer's symbols (espeak-ng is not on the machine). Returns the
    parameter bytes."""
    import numpy as np

    from localai_tfp_tpu_torch.models.piper import (_G2P_DIGRAPHS,
                                                    _G2P_SINGLE, _piper_name)

    d.mkdir(parents=True)
    sd = write_vits(vits_layout(LJS_BASE), seed)
    fused = {}
    for n, t in sd.items():
        if n.endswith("original1"):
            fused[n[: -len(".parametrizations.weight.original1")]
                  + ".weight"] = t
        elif not n.endswith("original0"):
            fused[n] = t
    graph = bytearray()
    for hf, t in fused.items():
        pn = _piper_name(hf)
        arr = t.numpy().astype(np.float32)
        if hf.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight",
                        "out_proj.weight")):
            arr = arr[..., None]
        tp = b"".join(_onnx_varint(1 << 3) + _onnx_varint(s)
                      for s in arr.shape)
        tp += _onnx_varint(2 << 3) + _onnx_varint(1)  # FLOAT
        tp += _onnx_ld(8, pn.encode()) + _onnx_ld(9, arr.tobytes())
        graph += _onnx_ld(5, tp)
    (d / "voice.onnx").write_bytes(_onnx_ld(7, bytes(graph)))
    symbols = sorted({c for _, ph in _G2P_DIGRAPHS for c in ph}
                     | {c for ph in _G2P_SINGLE.values() for c in ph})
    id_map = {"_": [0], "^": [1], "$": [2]}
    for i, s in enumerate(symbols):
        id_map[s] = [3 + i]
    (d / "voice.onnx.json").write_text(json.dumps({
        "audio": {"sample_rate": LJS_BASE["sampling_rate"]},
        "num_speakers": 1, "phoneme_type": "espeak",
        "espeak": {"voice": "en-us"}, "phoneme_id_map": id_map,
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8}}))
    return sum(t.numel() * 4 for t in fused.values())


def kokoro_layout(c: dict) -> list[tuple[str, tuple, str]]:
    """(module, state-dict name, shape) of a Kokoro checkpoint of config
    ``c`` in the official layout: PLBERT (transformers' AlbertModel),
    bert_encoder, text_encoder, predictor and decoder (weight-normed
    convolutions as ``weight_g`` [O, 1, 1] and ``weight_v``)."""
    ist, pl = c["istftnet"], c["plbert"]
    H, S, T = c["hidden_dim"], c["style_dim"], c["n_token"]
    B, I = pl["hidden_size"], pl["intermediate_size"]
    E = pl.get("embedding_size", 128)
    out = []

    def add(mod, name, shape):
        out.append((mod, name, tuple(shape)))

    def wn(mod, name, o, i, k, bias=True):
        add(mod, f"{name}.weight_g", (o, 1, 1))
        add(mod, f"{name}.weight_v", (o, i, k))
        if bias:
            add(mod, f"{name}.bias", (o,))

    def lstm(mod, name, i, h):
        for s in ("_l0", "_l0_reverse"):
            add(mod, f"{name}.weight_ih{s}", (4 * h, i))
            add(mod, f"{name}.weight_hh{s}", (4 * h, h))
            add(mod, f"{name}.bias_ih{s}", (4 * h,))
            add(mod, f"{name}.bias_hh{s}", (4 * h,))

    def lin(mod, name, o, i):
        add(mod, f"{name}.weight", (o, i))
        add(mod, f"{name}.bias", (o,))

    def ln(mod, name, n):
        add(mod, f"{name}.weight", (n,))
        add(mod, f"{name}.bias", (n,))

    def resblk(mod, name, din, dout, up=False):
        wn(mod, f"{name}.conv1", dout, din, 3)
        wn(mod, f"{name}.conv2", dout, dout, 3)
        lin(mod, f"{name}.norm1.fc", 2 * din, S)
        lin(mod, f"{name}.norm2.fc", 2 * dout, S)
        if din != dout:
            wn(mod, f"{name}.conv1x1", dout, din, 1, bias=False)
        if up:
            wn(mod, f"{name}.pool", din, 1, 3)

    def adain_res1(mod, name, ch, k, dil):
        for j in range(len(dil)):
            wn(mod, f"{name}.convs1.{j}", ch, ch, k)
            wn(mod, f"{name}.convs2.{j}", ch, ch, k)
            lin(mod, f"{name}.adain1.{j}.fc", 2 * ch, S)
            lin(mod, f"{name}.adain2.{j}.fc", 2 * ch, S)
            add(mod, f"{name}.alpha1.{j}", (1, ch, 1))
            add(mod, f"{name}.alpha2.{j}", (1, ch, 1))

    m = "bert"
    add(m, "embeddings.word_embeddings.weight", (T, E))
    add(m, "embeddings.position_embeddings.weight",
        (pl["max_position_embeddings"], E))
    add(m, "embeddings.token_type_embeddings.weight", (2, E))
    ln(m, "embeddings.LayerNorm", E)
    lin(m, "encoder.embedding_hidden_mapping_in", B, E)
    lp = "encoder.albert_layer_groups.0.albert_layers.0"
    ln(m, f"{lp}.full_layer_layer_norm", B)
    for p in ("query", "key", "value", "dense"):
        lin(m, f"{lp}.attention.{p}", B, B)
    ln(m, f"{lp}.attention.LayerNorm", B)
    lin(m, f"{lp}.ffn", I, B)
    lin(m, f"{lp}.ffn_output", B, I)
    lin("bert_encoder", "", H, B)
    m = "text_encoder"
    add(m, "embedding.weight", (T, H))
    for i in range(c["n_layer"]):
        wn(m, f"cnn.{i}.0", H, H, c["text_encoder_kernel_size"])
        add(m, f"cnn.{i}.1.gamma", (H,))
        add(m, f"cnn.{i}.1.beta", (H,))
    lstm(m, "lstm", H, H // 2)
    m = "predictor"
    for i in range(c["n_layer"]):
        lstm(m, f"text_encoder.lstms.{2 * i}", H + S, H // 2)
        lin(m, f"text_encoder.lstms.{2 * i + 1}.fc", 2 * H, S)
    lstm(m, "lstm", H + S, H // 2)
    lin(m, "duration_proj.linear_layer", c["max_dur"], H)
    lstm(m, "shared", H + S, H // 2)
    for br in ("F0", "N"):
        resblk(m, f"{br}.0", H, H)
        resblk(m, f"{br}.1", H, H // 2, up=True)
        resblk(m, f"{br}.2", H // 2, H // 2)
        add(m, f"{br}_proj.weight", (1, H // 2, 1))
        add(m, f"{br}_proj.bias", (1,))
    m = "decoder"
    dh, ar = c.get("decoder_hidden", 1024), c.get("asr_res_dim", 64)
    resblk(m, "encode", H + 2, dh)
    for i in range(3):
        resblk(m, f"decode.{i}", dh + 2 + ar, dh)
    resblk(m, "decode.3", dh + 2 + ar, ist["upsample_initial_channel"],
           up=True)
    wn(m, "F0_conv", 1, 1, 3)
    wn(m, "N_conv", 1, 1, 3)
    wn(m, "asr_res.0", ar, H, 1)
    g = "generator"
    nf = ist["gen_istft_n_fft"] + 2
    lin(m, f"{g}.m_source.l_linear", 1, 9)
    ch = ist["upsample_initial_channel"]
    rates = ist["upsample_rates"]
    for i, (u, k) in enumerate(zip(rates, ist["upsample_kernel_sizes"])):
        # a ConvTranspose1d: weight [in, out, k], its norm over dim 0
        wn(m, f"{g}.ups.{i}", ch, ch // 2, k, bias=False)
        add(m, f"{g}.ups.{i}.bias", (ch // 2,))
        ch //= 2
        if i + 1 < len(rates):
            s = 1
            for r in rates[i + 1:]:
                s *= r
            add(m, f"{g}.noise_convs.{i}.weight", (ch, nf, 2 * s))
        else:
            add(m, f"{g}.noise_convs.{i}.weight", (ch, nf, 1))
        add(m, f"{g}.noise_convs.{i}.bias", (ch,))
        adain_res1(m, f"{g}.noise_res.{i}", ch,
                   7 if i + 1 < len(rates) else 11, (1, 3, 5))
    for i in range(len(rates)):
        ch_i = ist["upsample_initial_channel"] // 2 ** (i + 1)
        for j, (k, dil) in enumerate(zip(ist["resblock_kernel_sizes"],
                                         ist["resblock_dilation_sizes"])):
            adain_res1(m, f"{g}.resblocks.{i * len(dil) + j}", ch_i, k, dil)
    wn(m, f"{g}.conv_post", nf, ch, 7)
    return [(mod, name.lstrip("."), shape) for mod, name, shape in out]


def kokoro_tensor(name: str, shape: tuple, gen) -> "torch.Tensor":
    """One random Kokoro tensor: norms and snake alphas 1, biases 0 (the
    duration projection's ``KOKORO_DUR_BIAS``), embeddings N(0, 0.02) as
    transformers draws ALBERT's (the text encoder's at 1), LSTM weights
    U(+-1/sqrt(hidden)) as torch draws them, other matrices at
    1/sqrt(fan-in) (the generator's last convolution at a tenth of that:
    log-magnitudes near 0); a weight norm's magnitude is its direction's
    norm."""
    import torch

    if "alpha" in name or name.endswith(("gamma", "LayerNorm.weight",
                                         "layer_norm.weight")):
        return torch.ones(shape)
    if name.endswith(("beta", "bias")) or "bias_" in name:
        if name.endswith("duration_proj.linear_layer.bias"):
            return torch.full(shape, KOKORO_DUR_BIAS)
        return torch.zeros(shape)
    if "weight_ih" in name or "weight_hh" in name:
        h = shape[0] // 4
        return (torch.rand(shape, generator=gen) * 2 - 1) * h ** -0.5
    w = torch.randn(shape, generator=gen)
    if "embeddings" in name:
        return w * 0.02
    if name.endswith("embedding.weight"):
        return w
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    if "conv_post" in name:  # the iSTFT's log-magnitudes near 0
        return w * 0.1 * fan_in ** -0.5
    return w * fan_in ** -0.5


def write_kokoro_dir(d: Path, seed: int) -> int:
    """Kokoro-82M's geometry in the official layout: config.json, a
    ``.pth`` of ``{"net": {module: state_dict}}`` and one voice pack.
    Returns the parameter bytes."""
    import torch

    d.mkdir(parents=True)
    gen = torch.Generator().manual_seed(seed)
    net: dict = {}
    for mod, name, shape in kokoro_layout(KOKORO_82M):
        net.setdefault(mod, {})[name] = kokoro_tensor(name, shape, gen)
    for sd in net.values():
        for n in list(sd):
            if n.endswith("weight_g"):
                v = sd[n[:-1] + "v"]
                sd[n] = v.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    torch.save({"net": net}, d / "kokoro-v0_19.pth")
    (d / "config.json").write_text(json.dumps(KOKORO_82M, indent=1))
    (d / "voices").mkdir()
    torch.save(torch.randn(KOKORO_VOICE_ROWS, 1,
                           2 * KOKORO_82M["style_dim"], generator=gen) * 0.1,
               d / "voices" / "af.pt")
    return sum(t.numel() * 4 for sd in net.values() for t in sd.values())


def encodec_layout(c: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of an HF EncodecModel's quantizer codebooks and
    decoder (weight-normed convolutions as ``parametrizations``)."""
    import math

    n_q = int(1000 * max(c["target_bandwidths"]) // (
        c["sampling_rate"] // math.prod(c["upsampling_ratios"]) * 10))
    out = [(f"quantizer.layers.{q}.codebook.embed",
            (c["codebook_size"], c["codebook_dim"])) for q in range(n_q)]

    def conv(idx, sub, o, i, k):
        p = f"decoder.layers.{idx}.{sub}"
        return [(f"{p}.parametrizations.weight.original0", (o, 1, 1)),
                (f"{p}.parametrizations.weight.original1", (o, i, k)),
                (f"{p}.bias", (o,))]

    scale = 2 ** len(c["upsampling_ratios"])
    ch = scale * c["num_filters"]
    out += conv(0, "conv", ch, c["hidden_size"], c["kernel_size"])
    for li in range(c["num_lstm_layers"]):
        for n, shape in (("weight_ih", (4 * ch, ch)),
                         ("weight_hh", (4 * ch, ch)),
                         ("bias_ih", (4 * ch,)), ("bias_hh", (4 * ch,))):
            out.append((f"decoder.layers.1.lstm.{n}_l{li}", shape))
    idx = 2
    for r in c["upsampling_ratios"]:
        idx += 1  # the ELU before the upsampler
        p = f"decoder.layers.{idx}.conv"
        out += [(f"{p}.parametrizations.weight.original0", (ch, 1, 1)),
                (f"{p}.parametrizations.weight.original1",
                 (ch, ch // 2, 2 * r)), (f"{p}.bias", (ch // 2,))]
        ch //= 2
        idx += 1
        hid = ch // c["compress"]
        out += conv(idx, "block.1.conv", hid, ch, c["residual_kernel_size"])
        out += conv(idx, "block.3.conv", ch, hid, 1)
        out += conv(idx, "shortcut.conv", ch, ch, 1)
        idx += 1
    out += conv(idx + 1, "conv", c["audio_channels"], ch,
                c["last_kernel_size"])
    return out


def write_oute_dir(d: Path, seed: int) -> int:
    """OuteTTS-0.2-500M's LM at Qwen2.5-0.5B's widths (random bf16, made
    on the card) with a byte-level BPE whose prompt markers are special
    added tokens and whose 1024 ``<|c_N|>`` codes (the codec's codebook)
    are added tokens at the top of the vocabulary, the tied head's code
    rows at ``OUTE_CODE_SCALE``x the others; under ``codec/`` the
    encodec_24khz decoder (f32, random); a speaker profile. Returns the
    parameter bytes."""
    import math

    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import (save_file,
                                                             save_iter)

    g = QWEN25_05B
    d.mkdir(parents=True)
    n_codes = ENCODEC_24KHZ["codebook_size"]
    # the byte-level BPE (ids below V - specials - codes), then the
    # markers, then the codes
    V = g["vocab_size"]
    vocab, merges = text_vocab(V, len(OUTE_SPECIALS) + n_codes)
    base = len(vocab)
    added = [{"id": base + k, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for k, t in enumerate(OUTE_SPECIALS)]
    code0 = base + len(OUTE_SPECIALS)
    added += [{"id": code0 + k, "content": f"<|c_{k}|>",
               "single_word": False, "lstrip": False, "rstrip": False,
               "normalized": False, "special": False}
              for k in range(n_codes)]
    (d / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}}, ensure_ascii=False))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": None, "eos_token": "<|im_end|>"}))
    D, F, L = g["hidden_size"], g["intermediate_size"], g["num_hidden_layers"]
    dh = D // g["num_attention_heads"]
    kv = g["num_key_value_heads"] * dh
    layout = [("model.embed_tokens.weight", (V, D)), ("model.norm.weight", (D,))]
    for i in range(L):
        lp = f"model.layers.{i}."
        layout += [(lp + "self_attn.q_proj.weight", (D, D)),
                   (lp + "self_attn.q_proj.bias", (D,)),
                   (lp + "self_attn.k_proj.weight", (kv, D)),
                   (lp + "self_attn.k_proj.bias", (kv,)),
                   (lp + "self_attn.v_proj.weight", (kv, D)),
                   (lp + "self_attn.v_proj.bias", (kv,)),
                   (lp + "self_attn.o_proj.weight", (D, D)),
                   (lp + "mlp.gate_proj.weight", (F, D)),
                   (lp + "mlp.up_proj.weight", (F, D)),
                   (lp + "mlp.down_proj.weight", (D, F)),
                   (lp + "input_layernorm.weight", (D,)),
                   (lp + "post_attention_layernorm.weight", (D,))]
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def tensors():
        for name, shape in layout:
            if len(shape) == 1:
                yield name, torch.full(shape, 0.0 if name.endswith(".bias")
                                       else 1.0, dtype=torch.bfloat16,
                                       device=dev)
                continue
            w = torch.randn(shape, generator=gen, device=dev) \
                * shape[1] ** -0.5
            if name.endswith("embed_tokens.weight"):
                # a tied head: the rows at 1/20 (the greedy ids would
                # echo the input at full scale), the code rows larger
                w /= 20
                w[code0:code0 + n_codes] *= OUTE_CODE_SCALE
            yield name, w.to(torch.bfloat16)

    shapes = [(n, torch.empty(s, dtype=torch.bfloat16, device="meta"))
              for n, s in layout]
    save_iter(tensors(), str(d / "model.safetensors"), shapes=shapes)
    (d / "config.json").write_text(json.dumps(g, indent=1))
    cg = torch.Generator().manual_seed(seed + 1)
    sd = {}
    layout = encodec_layout(ENCODEC_24KHZ)
    head = layout[-1][0].rsplit(".", 2)[0]  # the last conv: the waveform
    for name, shape in layout:
        if name.endswith("bias") or "bias_" in name:
            sd[name] = torch.zeros(shape)
        elif "weight_ih" in name or "weight_hh" in name:
            sd[name] = (torch.rand(shape, generator=cg) * 2 - 1) \
                * (shape[0] // 4) ** -0.5
        elif name.endswith("codebook.embed"):
            sd[name] = torch.randn(shape, generator=cg)
        else:
            # the head at a twentieth of the scale: samples inside the
            # decoder's clamp to [-1, 1]
            sd[name] = torch.randn(shape, generator=cg) \
                * math.prod(shape[1:]) ** -0.5 * (0.05 if head in name else 1)
    for n in sd:
        if n.endswith("original0"):
            v = sd[n[:-1] + "1"]
            sd[n] = v.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    (d / "codec").mkdir()
    save_file(sd, str(d / "codec" / "model.safetensors"))
    (d / "codec" / "config.json").write_text(json.dumps(ENCODEC_24KHZ))
    (d / "speaker.json").write_text(json.dumps(
        {"text": "hello there", "codes": list(range(0, 150, 3))}))
    return sum(2 * math.prod(s) for _, s in layout) \
        + sum(t.numel() * 4 for t in sd.values())


def _wav_samples(body: bytes) -> tuple:
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        return ((w.getnchannels(), w.getsampwidth(), w.getframerate()),
                np.frombuffer(w.readframes(w.getnframes()), "<i2"))


def _pcm16(audio) -> "np.ndarray":
    """The worker's WAV samples of a waveform (``write_wav``'s cast)."""
    import numpy as np

    return np.clip(np.asarray(audio) * 32767.0, -32768, 32767).astype("<i2")


def tts_requests(port: int, name: str, voice: str, rate: int,
                 routes=("speech", "tts", "elevenlabs")) -> dict:
    """The model behind its YAML through /v1/audio/speech, /tts and
    /v1/text-to-speech/{voice} (those of ``routes``): 200, audio/x-wav,
    the rate in the WAV header; request ms, the audio's seconds and the
    real-time factor; the samples of each."""
    from urllib.parse import quote

    out = {}
    for route, path, body in (
            ("speech", "/v1/audio/speech",
             {"model": name, "input": TTS_TEXT, "voice": voice}),
            # the config's tts.voice (the same voice, or none)
            ("tts", "/tts", {"model": name, "input": TTS_TEXT}),
            ("elevenlabs", f"/v1/text-to-speech/{quote(voice or 'alloy')}",
             {"model_id": name, "text": TTS_TEXT})):
        if route not in routes:
            continue
        t0 = time.perf_counter()
        status, headers, data = _req(port, "POST", path, body)
        ms = (time.perf_counter() - t0) * 1e3
        ctype = headers.get("Content-Type", "")
        if status != 200 or ctype != "audio/x-wav":
            raise AssertionError(f"tts {name} {path}: {status} {ctype} "
                                 f"{data[:300]!r}")
        head, pcm = _wav_samples(data)
        if head != (1, 2, rate) or not len(pcm):
            raise AssertionError(f"tts {name} {path}: header {head}, "
                                 f"{len(pcm)} samples")
        seconds = len(pcm) / rate
        out[route] = {"request_ms": round(ms, 3), "audio_s": round(seconds, 3),
                      "rtf": round(ms / 1e3 / seconds, 4), "pcm": pcm}
    return out


def _held(what: str, card, cpu, tol: float = TTS_TOL) -> dict:
    """Card waveform against the CPU's: the same length, within ``tol``
    of max|CPU|."""
    import numpy as np

    card, cpu = np.asarray(card), np.asarray(cpu)
    if card.shape != cpu.shape or not np.isfinite(card).all():
        raise AssertionError(f"tts {what}: card {card.shape} against CPU "
                             f"{cpu.shape}, finite {np.isfinite(card).all()}")
    diff = np.abs(card - cpu)
    err = float(diff.max())
    bound = tol * float(np.abs(cpu).max())
    if not err <= bound:
        raise AssertionError(
            f"tts {what}: card against CPU {err} > {bound} at sample "
            f"{int(diff.argmax())} of {len(cpu)}; "
            f"{int((diff > bound).sum())} samples beyond")
    return {"max_abs_err": err, "max_abs_cpu": float(np.abs(cpu).max()),
            "tol": f"{tol} x max|CPU|, TF32 off", "samples": len(cpu)}


def _served(what: str, pcm, audio) -> int:
    """Served int16 samples against the card's own waveform: equal up to
    ``TTS_LSB`` (the cast's rounding of two runs of one program)."""
    import numpy as np

    ref = _pcm16(audio)
    if pcm.shape != ref.shape:
        raise AssertionError(f"tts {what}: served {pcm.shape} samples, the "
                             f"model's {ref.shape}")
    worst = int(np.abs(pcm.astype(np.int32) - ref).max())
    if worst > TTS_LSB:
        raise AssertionError(f"tts {what}: served samples {worst} apart")
    return worst


def _stage_ms(fn) -> float:
    """Device ms of one call (CUDA events, after a warm-up call)."""
    return round(_time_ms(fn, 3), 3)


def vits_check(backend, model_path: Path, served, speed: float,
               piper: bool, seed: int) -> dict:
    """The card's VITS (or piper voice) against the same model loaded on
    the CPU with the same numpy noise: the duration vector equal, the
    waveform within ``TTS_TOL``; the served samples the card's; device ms
    by stage."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.device import f32_products
    from localai_tfp_tpu_torch.models import vits as tv
    from localai_tfp_tpu_torch.models.piper import PiperVoice

    if piper:
        voice = backend._piper
        spec, params = voice.spec, voice.params
        ids = voice.phoneme_ids(TTS_TEXT)
        cpu_spec, cpu_params = (lambda v: (v.spec, v.params))(
            PiperVoice.load(str(model_path), "cpu"))
        rate = None  # the voice's own (its length scale)
    else:
        spec, params, _ = backend._vits
        ids = backend._vits_ids(TTS_TEXT)
        cpu_spec, cpu_params = tv.load_vits(str(model_path), "cpu")
        rate = spec.speaking_rate * speed
    card, dur = tv.synthesize_with_durations(spec, params, ids,
                                             speaking_rate=rate, seed=0)
    cpu, cpu_dur = tv.synthesize_with_durations(cpu_spec, cpu_params, ids,
                                                speaking_rate=rate, seed=0)
    del cpu_params
    if not np.array_equal(dur, cpu_dur):
        raise AssertionError(f"tts vits: durations {dur.tolist()} on the "
                             f"card, {cpu_dur.tolist()} on the CPU")
    out = {"tokens": len(ids), "frames": int(dur.sum()),
           "held": _held("vits", card, cpu),
           "served_lsb": _served("vits", served["speech"]["pcm"], card)}
    dev = params["text_encoder"]["embed"].device
    T = len(ids)
    ids_t = torch.as_tensor(np.asarray(ids)[None], device=dev)
    mask = torch.ones((1, T), device=dev)
    noise = torch.zeros((1, 2, T), device=dev)
    z = torch.randn((1, spec.flow_size, int(dur.sum())), device=dev)
    fmask = torch.ones((1, 1, z.shape[-1]), device=dev)
    with torch.inference_mode(), f32_products():
        hidden = tv.text_encoder(spec, params["text_encoder"], ids_t, mask)[0]
        lat = tv.flow_reverse(spec, params["flow"], z, fmask)
        out["device_ms"] = {
            "text_encoder": _stage_ms(lambda: tv.text_encoder(
                spec, params["text_encoder"], ids_t, mask)),
            "duration": _stage_ms(lambda: tv.duration_reverse(
                spec, params["duration"], hidden, mask[:, None], noise)),
            "flow": _stage_ms(lambda: tv.flow_reverse(
                spec, params["flow"], z, fmask)),
            "hifigan": _stage_ms(lambda: tv.hifigan(
                spec, params["decoder"], lat))}
    return out


def kokoro_check(backend, model_path: Path, served, voice: str,
                 seed: int) -> dict:
    """The card's Kokoro against the same model on the CPU with one
    injected source-noise sample: durations equal, audio within
    ``TTS_TOL``; the served samples the card's (its seeded generator
    noise); device ms by stage."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.device import f32_products
    from localai_tfp_tpu_torch.models import kokoro as tk

    spec, params, voices = backend._kokoro
    ids = tk.text_to_tokens(TTS_TEXT, spec.n_token)
    ref = tk.pick_voice(voices, voice, len(ids), spec.style_dim)
    tokens = [0, *ids, 0]
    out = {"tokens": len(tokens),
           "served_lsb": _served("kokoro", served["speech"]["pcm"],
                                 tk.synthesize_kokoro(spec, params, tokens,
                                                      ref))}
    cspec, cparams, _ = tk.load_kokoro(str(model_path), "cpu")
    dev = params["text_encoder.embedding.weight"].device
    tok = torch.tensor([tokens], device=dev)
    s_pros = torch.from_numpy(ref[:, spec.style_dim:]).to(dev)
    with torch.inference_mode(), torch.no_grad():
        dur, d = tk.durations(spec, params, tok, s_pros)
        cdur, _ = tk.durations(cspec, cparams, tok.cpu(), s_pros.cpu())
    if not torch.equal(dur.cpu(), cdur):
        raise AssertionError(f"tts kokoro: durations {dur.tolist()} on the "
                             f"card, {cdur.tolist()} on the CPU")
    n = int(dur.sum())
    noise = np.random.default_rng(seed).standard_normal(
        (1, 2 * n * spec.total_upsample, spec.harmonic_num + 1)
    ).astype(np.float32)
    card = tk.synthesize_kokoro(spec, params, tokens, ref,
                                source_noise=noise)
    cpu = tk.synthesize_kokoro(cspec, cparams, tokens, ref,
                               source_noise=noise)
    out.update(frames=n, held=_held("kokoro", card, cpu))
    with torch.inference_mode(), f32_products():
        en = torch.repeat_interleave(d.transpose(1, 2), dur, dim=-1)
        f0, nc = tk._prosody_f0n(spec, params, en, s_pros)
        asr = torch.repeat_interleave(tk._text_encoder(spec, params, tok),
                                      dur, dim=-1)
        s_ref = torch.from_numpy(ref[:, :spec.style_dim]).to(dev)
        out["device_ms"] = {
            "durations": _stage_ms(lambda: tk.durations(spec, params, tok,
                                                        s_pros)),
            "prosody": _stage_ms(lambda: tk._prosody_f0n(spec, params, en,
                                                         s_pros)),
            "text_encoder": _stage_ms(lambda: tk._text_encoder(spec, params,
                                                               tok)),
            "decoder": _stage_ms(lambda: tk._decoder(spec, params, asr, f0,
                                                     nc, s_ref, seed))}
    return out


def oute_check(backend, model_path: Path, served) -> dict:
    """OuteTTS on the card: a greedy generation of OUTE_GREEDY_TOKENS
    held to the plain dense forward (``dense_deficits``: every pick the
    argmax up to a quarter of the logits' std), its codes decoded on the
    card against the same codes on the CPU's codec within ``TTS_TOL``;
    the codec's device ms for a served request's frames."""
    import math

    import numpy as np

    from localai_tfp_tpu_torch.models import encodec as te
    from localai_tfp_tpu_torch.models.safetensors_io import load_file

    m = backend._outetts
    text = m.generate(TTS_TEXT, temperature=0.0,
                      max_tokens=OUTE_GREEDY_TOKENS)
    ids = m.tokenizer.encode(text)
    if len(ids) != OUTE_GREEDY_TOKENS or not all(i in m.code_ids
                                                for i in ids):
        raise AssertionError(f"tts outetts: the greedy run's {len(ids)} ids "
                             "are not all codes")
    prompt = m.tokenizer.encode(m._prompt(TTS_TEXT, None), add_bos=True)
    dense = dense_deficits(m.engine, prompt, ids)
    if not dense["worst_logit_deficit"] <= dense["tol"]:
        raise AssertionError(f"tts outetts: greedy ids off the dense "
                             f"argmax: {dense}")
    codes = m.codes(text)
    card = te.encodec_decode(m.codec, codes, m.ratios)
    cpu_codec = te.load_encodec_decoder(
        load_file(str(model_path / "codec" / "model.safetensors")),
        prefix="", device="cpu")
    out = {"greedy": dense,
           "held": _held("outetts codec", card,
                         te.encodec_decode(cpu_codec, codes, m.ratios))}
    frames = len(served["speech"]["pcm"]) // math.prod(m.ratios)
    many = np.resize(codes, (1, frames))
    out["codec_device_ms"] = {"frames": frames, "ms": _stage_ms(
        lambda: te.encodec_decode(m.codec, many, m.ratios))}
    return out


def phase_tts(smi: str, seed: int) -> dict:
    """Speech out through the HTTP server at published widths, random
    weights from ``seed``: facebook/mms-tts-eng's VITS (16 kHz, with its
    character tokenizer), a piper voice at ljs_base's widths (22050 Hz),
    Kokoro-82M with one voice pack (24 kHz) and OuteTTS-0.2-500M's LM
    (Qwen2.5-0.5B's widths, 24 layers, 14 / 2 heads of 64) over
    encodec_24khz's decoder, each behind its YAML through
    /v1/audio/speech, /tts and /v1/text-to-speech/{voice}; the formant
    voice and /v1/sound-generation's noise bands against the host's
    bytes. Each model is held to the same model loaded on the CPU (same
    noise, TF32 off), its served samples to its own card waveform, then
    unloaded: allocated bytes back within LC_SLACK of the baseline. B1's
    launches by OuteTTS's served requests are counted."""
    import shutil
    import tempfile
    import threading

    import torch

    from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )
    from localai_tfp_tpu_torch.server.app import Server
    from localai_tfp_tpu_torch.server.state import Application
    from localai_tfp_tpu_torch.workers.tts import (_g2p, _render,
                                                   noise_bands, write_wav)

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "tts"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    t0 = time.perf_counter()
    written = {
        "mms": write_mms_dir(models / "mms-tts-eng", seed),
        "piper": write_piper_voice_files(models / "piper", seed + 1),
        "kokoro": write_kokoro_dir(models / "kokoro-82m", seed + 2),
        "oute": write_oute_dir(models / "outetts-0.2-500m", seed + 3),
    }
    log("tts_checkpoints", bytes=written,
        write_s=round(time.perf_counter() - t0, 3), card=smi)
    yamls = {
        "voice": {"backend": "tts"},
        "mms": {"backend": "tts", "parameters": {"model": "mms-tts-eng"},
                "tts": {"voice": "nova"}},
        "piper": {"backend": "piper",
                  "parameters": {"model": "piper/voice.onnx"}},
        "kokoro": {"backend": "kokoro",
                   "parameters": {"model": "kokoro-82m"},
                   "tts": {"voice": "af"}},
        "oute": {"backend": "tts", "type": "OuteTTS",
                 "parameters": {"model": "outetts-0.2-500m"}},
    }
    for name, doc in yamls.items():
        (models / f"{name}.yaml").write_text(json.dumps({"name": name,
                                                         **doc}))
    out = {"checkpoint_bytes": written}
    base = _mem()
    # the server's WAVs under the phase's directory (its own default is
    # the working directory's generated_content/)
    srv = Server(Application(ApplicationConfig(
        models_path=str(models), address="127.0.0.1", port=0,
        generated_content_dir=str(models / "generated")), CARD))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        app = srv.app
        tmp = Path(tempfile.mkdtemp(dir=models))
        # the formant voice and the noise bands: host numpy, the bytes of
        # the worker's own functions
        st, _, body = _req(port, "POST", "/tts", {"model": "voice",
                                                 "input": TTS_TEXT,
                                                 "voice": "nova"})
        write_wav(str(tmp / "f.wav"), _render(_g2p(TTS_TEXT), 175.0, 1.1))
        st2, _, body2 = _req(port, "POST", "/v1/sound-generation",
                             {"model_id": "voice", "text": "rain",
                              "duration_seconds": 2.0})
        write_wav(str(tmp / "n.wav"), noise_bands("rain", 2.0))
        if (st, st2) != (200, 200) or body != (tmp / "f.wav").read_bytes() \
                or body2 != (tmp / "n.wav").read_bytes():
            raise AssertionError(f"tts: formant {st} / sound generation "
                                 f"{st2} differ from the host's bytes")
        out["formant_and_sound_generation"] = "bytes equal"
        for name, voice, rate, path in (
                ("mms", "nova", MMS_TTS_ENG["sampling_rate"],
                 models / "mms-tts-eng"),
                ("piper", "", LJS_BASE["sampling_rate"],
                 models / "piper" / "voice.onnx"),
                ("kokoro", "af", 24000, models / "kokoro-82m"),
                ("oute", "speaker.json", ENCODEC_24KHZ["sampling_rate"],
                 models / "outetts-0.2-500m")):
            t_leg = time.perf_counter()
            if name == "oute":
                for f in (ragged_paged_attention, int8_matmul):
                    f.launches = 0
            # the first request loads the model
            served = tts_requests(port, name, voice, rate)
            leg = {"requests": {k: {kk: vv for kk, vv in v.items()
                                    if kk != "pcm"}
                                for k, v in served.items()}}
            if name == "oute":
                leg["launches"] = {
                    "ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
                layers = QWEN25_05B["num_hidden_layers"]
                b1 = leg["launches"]["ragged_paged_attention"]
                if b1 == 0 or b1 % layers:
                    raise AssertionError(f"tts outetts: B1 launched {b1} "
                                         f"times ({layers} layers)")
            lm = app.model_loader.get(name)
            backend = lm.backend
            leg["load_s"] = round(lm.load_s, 3)
            leg["family"] = backend.family()
            if name in ("mms", "piper"):
                leg.update(vits_check(backend, path, served, 1.1,
                                      name == "piper", seed))
            elif name == "kokoro":
                leg.update(kokoro_check(backend, path, served, voice, seed))
            else:
                leg.update(oute_check(backend, path, served))
            loaded = _mem()
            del backend, lm, served
            st, _, msg = _req(port, "POST", "/backend/shutdown",
                              {"model": name})
            if st != 200:
                raise AssertionError(f"tts {name}: shutdown {st} {msg!r}")
            gc_mem = _mem()
            leg["memory"] = {"baseline": base["allocated"],
                             "loaded": loaded["allocated"],
                             "after_unload": gc_mem["allocated"],
                             "residue": _back(f"tts {name}",
                                              gc_mem["allocated"], base)}
            leg["leg_s"] = round(time.perf_counter() - t_leg, 3)
            log(f"tts_{name}", **leg, card=smi)
            out[name] = leg
    finally:
        _shut(srv, th)
        shutil.rmtree(models, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("tts", phase_s=out["phase_s"], card=smi)
    return out


# ------------------------------------------------------------- phase tts_ar
#
# The autoregressive speech and sound families at published widths, random
# weights from the seed: suno/bark-small's three GPTs over phase tts's
# encodec_24khz decoder, coqui/XTTS-v2's GPT-2 and HiFiGAN with one voice,
# facebook/musicgen-small (t5-base's encoder, the 24-layer decoder, the
# encodec_32khz decoder), each behind its YAML through the speech routes
# or /v1/sound-generation, each greedy stage held to a teacher-forced
# forward of the same model on the CPU, and the card's codes or latents
# decoded on the CPU. Neither kernel runs: the JAX package's three
# families have their own loops and reach no Pallas kernel.

_BARK_GPT = {"hidden_size": 768, "num_layers": 12, "num_heads": 12,
             "block_size": 1024, "bias": False, "dropout": 0.0}
# suno/bark-small's config.json (its codec is facebook/encodec_24khz)
BARK_SMALL = {
    "model_type": "bark",
    "semantic_config": {**_BARK_GPT, "input_vocab_size": 129600,
                        "output_vocab_size": 10048},
    "coarse_acoustics_config": {**_BARK_GPT, "input_vocab_size": 12096,
                                "output_vocab_size": 12096},
    "fine_acoustics_config": {**_BARK_GPT, "input_vocab_size": 1056,
                              "output_vocab_size": 1056,
                              "n_codes_total": 8, "n_codes_given": 1},
    "codec_config": ENCODEC_24KHZ,
}
# coqui/XTTS-v2's config.json: the keys models/xtts.py reads (its XttsSpec
# defaults); the HiFiGAN geometry, fixed in code there, as config keys
XTTS_V2 = {
    "model": "xtts",
    "model_args": {
        "gpt_layers": 30, "gpt_n_model_channels": 1024, "gpt_n_heads": 16,
        "gpt_number_text_tokens": 6681, "gpt_num_audio_tokens": 1026,
        "gpt_start_audio_token": 1024, "gpt_stop_audio_token": 1025,
        "gpt_start_text_token": 261, "gpt_stop_text_token": 0,
        "gpt_max_audio_tokens": 605, "gpt_max_text_tokens": 402,
        "gpt_num_audio_channels": 80, "decoder_input_dim": 1024,
        "d_vector_dim": 512},
    "audio": {"output_sample_rate": 24000},
}
XTTS_HIFIGAN = {"up_initial": 512, "up_rates": [8, 8, 2, 2],
                "up_kernels": [16, 16, 4, 4], "resblock_kernels": [3, 7, 11],
                "resblock_dilations": [[1, 3, 5]] * 3}
XTTS_LANGS = ["en", "es", "fr", "de", "it", "pt", "pl", "tr", "ru", "nl",
              "cs", "ar", "zh-cn", "hu", "ko", "ja", "hi"]
XTTS_STOP_BIAS = -5.0  # the stop code's logit, ~8 std below the others:
# a random GPT runs all 605 steps
# facebook/musicgen-small's config.json: t5-base's encoder, the decoder,
# facebook/encodec_32khz (its use_conv_shortcut is false: ROADMAP §C 18)
T5_BASE = {"vocab_size": 32128, "d_model": 768, "d_kv": 64, "d_ff": 3072,
           "num_layers": 12, "num_heads": 12,
           "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128,
           "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu"}
MUSICGEN_SMALL_DECODER = {
    "vocab_size": 2048, "hidden_size": 1024, "num_hidden_layers": 24,
    "num_attention_heads": 16, "ffn_dim": 4096, "num_codebooks": 4,
    "pad_token_id": 2048, "bos_token_id": 2048, "scale_embedding": False,
    "max_position_embeddings": 2048, "activation_function": "gelu"}
ENCODEC_32KHZ = {
    "model_type": "encodec", "sampling_rate": 32000, "audio_channels": 1,
    "num_filters": 64, "upsampling_ratios": [8, 5, 4, 4],
    "hidden_size": 128, "codebook_size": 2048, "codebook_dim": 128,
    "num_lstm_layers": 2, "kernel_size": 7, "last_kernel_size": 7,
    "residual_kernel_size": 3, "dilation_growth_rate": 2,
    "num_residual_layers": 1, "compress": 2, "target_bandwidths": [2.2],
    "norm_type": "weight_norm", "use_causal_conv": False,
    "pad_mode": "reflect", "trim_right_ratio": 1.0,
    "use_conv_shortcut": False}
MUSICGEN_SECONDS = 5.0  # /v1/sound-generation's duration (its default)
MUSICGEN_TEXT = "lo-fi hip hop beat with a warm bass line"
TTS_AR_TOL = 1e-4  # the card's codes or latents decoded on the CPU
# against the card's waveform, of max|CPU|; f32, TF32 off


def _randn(shape, gen, std):
    """N(0, std) drawn on the generator's device, returned on the host."""
    import torch

    return (torch.randn(shape, generator=gen, device=gen.device) * std).cpu()


def _codec_tensors(layout: list, gen, prefix: str = "") -> dict:
    """Random EnCodec tensors for ``encodec_layout``'s names: codebooks
    N(0, 1), LSTM weights U(+-1/sqrt(H)), convolutions at 1/sqrt(fan-in)
    (the head at a twentieth: samples inside the clamp), biases 0; each
    weight norm's magnitude its direction's norm."""
    import math

    import torch

    sd = {}
    head = layout[-1][0].rsplit(".", 2)[0]
    for name, shape in layout:
        if name.endswith("bias") or "bias_" in name:
            sd[name] = torch.zeros(shape)
        elif "weight_ih" in name or "weight_hh" in name:
            sd[name] = (torch.rand(shape, generator=gen) * 2 - 1) \
                * (shape[0] // 4) ** -0.5
        elif name.endswith("codebook.embed"):
            sd[name] = torch.randn(shape, generator=gen)
        else:
            sd[name] = _randn(shape, gen, math.prod(shape[1:]) ** -0.5
                              * (0.05 if head in name else 1))
    for n in sd:
        if n.endswith("original0"):
            sd[n] = sd[n[:-1] + "1"].flatten(1).norm(dim=1).reshape(-1, 1, 1)
    return {prefix + k: v for k, v in sd.items()}


def write_bark_dir(d: Path, seed: int) -> int:
    """bark-small's three GPTs (bias-free LayerNorms, fused qkv; the fine
    stage's tied heads dropped, as the published checkpoint drops them)
    at N(0, 0.02) as transformers draws them, the semantic head's stop
    column (10 000) zero so that the random model runs its 256 steps,
    and encodec_24khz's decoder under ``codec_model.``. Returns the
    parameter bytes."""
    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_file

    d.mkdir(parents=True)
    gen = torch.Generator(device=CARD).manual_seed(seed)
    sd = {}
    for pre, key in (("semantic.", "semantic_config"),
                     ("coarse_acoustics.", "coarse_acoustics_config"),
                     ("fine_acoustics.", "fine_acoustics_config")):
        c = BARK_SMALL[key]
        H = c["hidden_size"]
        sd[pre + "position_embeds_layer.weight"] = _randn(
            (c["block_size"], H), gen, 0.02)
        for i in range(c["num_layers"]):
            lp = f"{pre}layers.{i}."
            sd[lp + "layernorm_1.weight"] = torch.ones(H)
            sd[lp + "layernorm_2.weight"] = torch.ones(H)
            for name, shape in (("attn.att_proj", (3 * H, H)),
                                ("attn.out_proj", (H, H)),
                                ("mlp.in_proj", (4 * H, H)),
                                ("mlp.out_proj", (H, 4 * H))):
                sd[f"{lp}{name}.weight"] = _randn(shape, gen, 0.02)
        sd[pre + "layernorm_final.weight"] = torch.ones(H)
        if "n_codes_total" in c:
            for i in range(c["n_codes_total"]):
                sd[f"{pre}input_embeds_layers.{i}.weight"] = _randn(
                    (c["input_vocab_size"], H), gen, 0.02)
        else:
            sd[pre + "input_embeds_layer.weight"] = _randn(
                (c["input_vocab_size"], H), gen, 0.02)
            head = _randn((c["output_vocab_size"], H), gen, 0.02)
            if pre == "semantic.":
                head[10_000] = 0.0
            sd[pre + "lm_head.weight"] = head
    sd.update(_codec_tensors(encodec_layout(ENCODEC_24KHZ),
                             torch.Generator().manual_seed(seed + 1),
                             "codec_model."))
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(BARK_SMALL, indent=1))
    return sum(t.numel() * 4 for t in sd.values())


def xtts_vocab() -> dict:
    """An XTTS-layout ``vocab.json`` written without ``tokenizers``:
    [STOP], [UNK], [SPACE], the printable ASCII characters, merges of
    every two lowercase letters, the language tags as special added
    tokens, a ``Whitespace`` pre-tokenizer."""
    import string

    specials = ["[STOP]", "[UNK]", "[SPACE]"]
    vocab = {t: i for i, t in enumerate(specials)}
    for c in (chr(b) for b in range(0x21, 0x7F)):
        vocab[c] = len(vocab)
    merges = []
    for a in string.ascii_lowercase:
        for b in string.ascii_lowercase:
            vocab[a + b] = len(vocab)
            merges.append(f"{a} {b}")
    added = []
    for t in specials + [f"[{lang}]" for lang in XTTS_LANGS]:
        vocab.setdefault(t, len(vocab))
        added.append({"id": vocab[t], "content": t, "single_word": False,
                      "lstrip": False, "rstrip": False, "normalized": False,
                      "special": True})
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
            "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "vocab": vocab, "merges": merges}}


def write_xtts_dir(d: Path, seed: int) -> int:
    """XTTS-v2's GPT-2 (30 x 1024, 16 heads; N(0, 0.02), the stop code's
    bias ``XTTS_STOP_BIAS``) and HiFiGAN (512 channels x 256, weight-normed
    as ``weight_g``/``weight_v``, convolutions at 0.5 / sqrt(fan-in), the
    last at a tenth) in the official ``{"model": state_dict}`` layout,
    config.json, vocab.json and a speakers file with one voice. The
    conditioning encoder is not written: the served path reads a voice's
    latents from the speakers file. Returns the parameter bytes."""
    import torch

    d.mkdir(parents=True)
    gen = torch.Generator(device=CARD).manual_seed(seed)
    a = XTTS_V2["model_args"]
    D, n_audio = a["gpt_n_model_channels"], a["gpt_num_audio_tokens"]
    sd = {
        "gpt.text_embedding.weight": _randn(
            (a["gpt_number_text_tokens"], D), gen, 0.02),
        "gpt.text_pos_embedding.emb.weight": _randn(
            (a["gpt_max_text_tokens"] + 2, D), gen, 0.02),
        "gpt.mel_embedding.weight": _randn((n_audio, D), gen, 0.02),
        "gpt.mel_pos_embedding.emb.weight": _randn(
            (a["gpt_max_audio_tokens"] + 2, D), gen, 0.02),
        "gpt.mel_head.weight": _randn((n_audio, D), gen, 0.02),
        "gpt.gpt.ln_f.weight": torch.ones(D),
        "gpt.gpt.ln_f.bias": torch.zeros(D),
    }
    bias = torch.zeros(n_audio)
    bias[a["gpt_stop_audio_token"]] = XTTS_STOP_BIAS
    sd["gpt.mel_head.bias"] = bias
    for i in range(a["gpt_layers"]):
        lp = f"gpt.gpt.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[lp + ln + ".weight"] = torch.ones(D)
            sd[lp + ln + ".bias"] = torch.zeros(D)
        for name, shape in (("attn.c_attn", (D, 3 * D)),
                            ("attn.c_proj", (D, D)),
                            ("mlp.c_fc", (D, 4 * D)),
                            ("mlp.c_proj", (4 * D, D))):
            sd[lp + name + ".weight"] = _randn(shape, gen, 0.02)
            sd[lp + name + ".bias"] = torch.zeros(shape[1])
    wd = "hifigan_decoder.waveform_decoder."

    def conv(name, shape, n_bias, fan, scale=0.5):
        v = _randn(shape, gen, scale * fan ** -0.5)
        sd[wd + name + ".weight_v"] = v
        sd[wd + name + ".weight_g"] = v.flatten(1).norm(dim=1).reshape(
            -1, 1, 1)
        sd[wd + name + ".bias"] = torch.zeros(n_bias)

    h = XTTS_HIFIGAN
    ch, dv = h["up_initial"], a["d_vector_dim"]
    conv("conv_pre", (ch, a["decoder_input_dim"], 7), ch,
         a["decoder_input_dim"] * 7)
    sd[wd + "cond_layer.weight"] = _randn((ch, dv, 1), gen, dv ** -0.5)
    sd[wd + "cond_layer.bias"] = torch.zeros(ch)
    n_k = len(h["resblock_kernels"])
    for u, (r, k) in enumerate(zip(h["up_rates"], h["up_kernels"])):
        # a ConvTranspose1d: weight [in, out, k], its norm over dim 0
        conv(f"ups.{u}", (ch, ch // 2, k), ch // 2, ch * k // r)
        ch //= 2
        sd[wd + f"conds.{u}.weight"] = _randn((ch, dv, 1), gen, dv ** -0.5)
        sd[wd + f"conds.{u}.bias"] = torch.zeros(ch)
        for kk, (rk, dils) in enumerate(zip(h["resblock_kernels"],
                                            h["resblock_dilations"])):
            for j in range(len(dils)):
                for c in ("convs1", "convs2"):
                    conv(f"resblocks.{u * n_k + kk}.{c}.{j}", (ch, ch, rk),
                         ch, ch * rk)
    conv("conv_post", (1, ch, 7), 1, ch * 7, scale=0.1)
    torch.save({"model": sd}, d / "model.pth")
    cfg = json.loads(json.dumps(XTTS_V2))
    cfg["model_args"].update({f"hifigan_{k}": v for k, v in h.items()})
    (d / "config.json").write_text(json.dumps(cfg, indent=1))
    (d / "vocab.json").write_text(json.dumps(xtts_vocab()))
    torch.save({"ana": {
        "gpt_cond_latent": _randn((1, 32, D), gen, 0.02),
        "speaker_embedding": _randn((1, dv, 1), gen, 1.0)}},
        d / "speakers_xtts.pth")
    return sum(t.numel() * 4 for t in sd.values())


def write_musicgen_dir(d: Path, seed: int) -> int:
    """musicgen-small as an HF MusicgenForConditionalGeneration directory:
    t5-base's encoder (matrices at 0.5 / sqrt(fan-in), the relative bias
    at 0.1, the embedding N(0, 1), tied and stored once as ``shared``),
    the decoder at N(0, 0.02) with ``enc_to_dec_proj`` (768 -> 1024), and
    encodec_32khz's decoder with the shortcut convolutions the loaders
    read (ROADMAP §C 18). No tokenizer.json: the text goes in as byte
    ids. Returns the parameter bytes."""
    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_file

    d.mkdir(parents=True)
    gen = torch.Generator(device=CARD).manual_seed(seed)
    t, m = T5_BASE, MUSICGEN_SMALL_DECODER
    E, inner, F_ = t["d_model"], t["num_heads"] * t["d_kv"], t["d_ff"]
    sd = {"text_encoder.shared.weight": _randn((t["vocab_size"], E), gen,
                                               1.0),
          "text_encoder.encoder.final_layer_norm.weight": torch.ones(E)}
    te = "text_encoder.encoder.block."
    sd[te + "0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
        _randn((t["relative_attention_num_buckets"], t["num_heads"]), gen,
               0.1)
    for i in range(t["num_layers"]):
        b = f"{te}{i}.layer."
        for w in "qkv":
            sd[f"{b}0.SelfAttention.{w}.weight"] = _randn((inner, E), gen,
                                                          0.5 * E ** -0.5)
        sd[f"{b}0.SelfAttention.o.weight"] = _randn((E, inner), gen,
                                                    0.5 * inner ** -0.5)
        sd[f"{b}0.layer_norm.weight"] = torch.ones(E)
        sd[f"{b}1.layer_norm.weight"] = torch.ones(E)
        sd[f"{b}1.DenseReluDense.wi.weight"] = _randn((F_, E), gen,
                                                      0.5 * E ** -0.5)
        sd[f"{b}1.DenseReluDense.wo.weight"] = _randn((E, F_), gen,
                                                      0.5 * F_ ** -0.5)
    D, V, nb = m["hidden_size"], m["vocab_size"], m["num_codebooks"]
    dd = "decoder.model.decoder."
    for cb in range(nb):
        sd[f"{dd}embed_tokens.{cb}.weight"] = _randn((V + 1, D), gen, 0.02)
        sd[f"decoder.lm_heads.{cb}.weight"] = _randn((V, D), gen, 0.02)
    sd[dd + "layer_norm.weight"] = torch.ones(D)
    sd[dd + "layer_norm.bias"] = torch.zeros(D)
    sd["enc_to_dec_proj.weight"] = _randn((D, E), gen, 0.02)
    sd["enc_to_dec_proj.bias"] = torch.zeros(D)
    for i in range(m["num_hidden_layers"]):
        b = f"{dd}layers.{i}."
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                   "final_layer_norm"):
            sd[f"{b}{ln}.weight"] = torch.ones(D)
            sd[f"{b}{ln}.bias"] = torch.zeros(D)
        for mod in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{b}{mod}.{proj}.weight"] = _randn((D, D), gen, 0.02)
        sd[b + "fc1.weight"] = _randn((m["ffn_dim"], D), gen, 0.02)
        sd[b + "fc2.weight"] = _randn((D, m["ffn_dim"]), gen, 0.02)
    sd.update(_codec_tensors(encodec_layout(ENCODEC_32KHZ),
                             torch.Generator().manual_seed(seed + 1),
                             "audio_encoder."))
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "model_type": "musicgen", "decoder_start_token_id": 2048,
        "pad_token_id": 2048, "text_encoder": {"model_type": "t5", **t},
        "decoder": {"model_type": "musicgen_decoder", **m},
        "audio_encoder": ENCODEC_32KHZ}, indent=1))
    return sum(t.numel() * 4 for t in sd.values())


def _pick_deficits(what: str, rows, picks) -> dict:
    """Card picks against a teacher-forced CPU forward's rows [n, V]:
    how many are its argmax, and the worst logit deficit against a
    tolerance of a quarter of the rows' std (f32 on both sides moves a
    logit by ~1e-5; a wrong weight or position moves it by whole std)."""
    import torch

    rows = torch.as_tensor(rows).float()
    tok = torch.as_tensor(picks, dtype=torch.long)
    if not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"tts_ar {what}: CPU logits not finite")
    deficit = rows.max(-1).values - rows.gather(-1, tok[:, None])[:, 0]
    out = {"tokens": len(tok),
           "exact_argmax": int((rows.argmax(-1) == tok).sum()),
           "worst_logit_deficit": float(deficit.max()),
           "tol": 0.25 * float(rows.std())}
    if not out["worst_logit_deficit"] <= out["tol"]:
        raise AssertionError(f"tts_ar {what}: card picks off the CPU "
                             f"argmax: {out}")
    return out


def _timed(fn):
    """(result, host seconds) of ``fn`` ended by a synchronize."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class _Recording:
    """Within ``with``, each ``(owner, name)`` callable records its last
    call's result and host seconds (``_timed``) in ``self.last[name]``:
    the stages of a served request, read by the checks without running
    them again."""

    def __init__(self, targets) -> None:
        # (owner, name, the callable, whether the owner itself held it: a
        # method wrapped on an instance is removed again, not set back)
        self.targets = [(o, n, getattr(o, n), n in vars(o))
                        for o, n in targets]
        self.last: dict = {}

    def __enter__(self) -> "_Recording":
        for owner, name, fn, _ in self.targets:
            setattr(owner, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def run(*a, **k):
            out, s = _timed(lambda: fn(*a, **k))
            self.last[name] = (out, s)
            return out
        return run

    def __exit__(self, *exc) -> None:
        for owner, name, fn, own in self.targets:
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def bark_check(bark, model_path: Path, served, rec) -> dict:
    """The served greedy bark request's stages (``rec``: host ms a token,
    the codes, the waveform), its served samples the card's waveform;
    device ms of one step of each stage; each stage's picks held to a
    teacher-forced forward on the CPU (each of the coarse stage's sliding
    windows a forward of its own, the fine stage one forward a codebook
    over the codebooks it had), its codes decoded on the CPU within
    ``TTS_AR_TOL``."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.device import f32_products
    from localai_tfp_tpu_torch.models import bark as tb
    from localai_tfp_tpu_torch.models.encodec import encodec_decode

    ids = [b % 1000 for b in TTS_TEXT.encode()]
    sem, sem_s = rec["semantic_tokens"]
    coarse, coarse_s = rec["coarse_tokens"]
    codes, fine_s = rec["fine_codes"]
    audio, codec_s = rec["encodec_decode"]
    codes = codes.cpu()
    block = bark.coarse_spec.block_size
    past = len(sem) + 2 + len(coarse) - 1 - block  # steps whose window slid
    out = {"semantic_tokens": len(sem), "coarse_tokens": len(coarse),
           "coarse_steps_slid": max(past, 0), "frames": codes.shape[0],
           "served_lsb": _served("bark", served["speech"]["pcm"], audio),
           "host_ms_per_token": {
               "semantic": round(sem_s * 1e3 / len(sem), 4),
               "coarse": round(coarse_s * 1e3 / len(coarse), 4)},
           "host_ms": {"fine": round(fine_s * 1e3, 3),
                       "codec": round(codec_s * 1e3, 3)}}
    if len(sem) != 256 or past < 1:
        raise AssertionError(f"tts_ar bark: {len(sem)} semantic tokens, "
                             f"{past} coarse steps past the window")
    # device ms: one cached step of each causal stage, one sliding step,
    # one fine codebook, the codec
    dev = bark.device
    with torch.inference_mode(), f32_products():
        dm = {}
        for stage, spec, p, n in (
                ("semantic_step", bark.semantic_spec, bark.semantic, 700),
                ("coarse_step", bark.coarse_spec, bark.coarse, 1000)):
            cache = tb.new_cache(spec, p)
            x = p["embed"][torch.zeros((1, n), dtype=torch.long,
                                       device=dev)]
            tb.bark_gpt_hidden(spec, p, x[:, :-1], cache)
            dm[stage] = _stage_ms(lambda: tb.bark_gpt_hidden(
                spec, p, x[:, -1:], cache, n - 1)[0, -1] @ p["head"])
        window = torch.zeros((1, block), dtype=torch.long, device=dev)
        dm["coarse_slide_step"] = _stage_ms(lambda: tb.bark_causal_logits(
            bark.coarse_spec, bark.coarse, window)[0, -1])
        c_dev = codes.to(dev)[None]
        dm["fine_codebook"] = _stage_ms(lambda: tb.bark_fine_logits(
            bark.fine_spec, bark.fine, c_dev, 2))
        dm["codec"] = _stage_ms(lambda: encodec_decode(
            bark.codec, np.asarray(codes.T), bark.ratios))
    out["device_ms"] = dm
    cpu = tb.BarkTTS.load(str(model_path), "cpu")
    prompt = ([t + tb.TEXT_ENCODING_OFFSET for t in ids]
              + [tb.TEXT_PAD_TOKEN] * (256 - len(ids))
              + [tb.SEMANTIC_PAD_TOKEN] * 256 + [tb.SEMANTIC_INFER_TOKEN])
    with torch.inference_mode():
        lg = tb.bark_causal_logits(cpu.semantic_spec, cpu.semantic,
                                   torch.tensor([prompt + sem[:-1]])
                                   )[0, len(prompt) - 1:]
        rows = torch.cat([lg[:, :tb.SEMANTIC_VOCAB_SIZE],
                          lg[:, tb.SEMANTIC_PAD_TOKEN:
                             tb.SEMANTIC_PAD_TOKEN + 1]], 1)
        out["semantic_greedy"] = _pick_deficits("bark semantic", rows, sem)
        full = sem + [tb.COARSE_SEMANTIC_PAD_TOKEN, tb.COARSE_INFER_TOKEN] \
            + coarse
        n0 = len(sem) + 2
        first = tb.bark_causal_logits(cpu.coarse_spec, cpu.coarse,
                                      torch.tensor([full[:block]]))[0]
        rows, picks = [], []
        for j, tok in enumerate(coarse):
            n = n0 + j
            if n <= block:
                row = first[n - 1]
            else:  # a sliding window: a forward of its own
                row = tb.bark_causal_logits(
                    cpu.coarse_spec, cpu.coarse,
                    torch.tensor([full[n - block:n]]))[0, -1]
            lo = tb.SEMANTIC_VOCAB_SIZE + (j % 2) * tb.CODEBOOK_SIZE
            rows.append(row[lo:lo + tb.CODEBOOK_SIZE])
            picks.append(tok - lo)
        out["coarse_greedy"] = _pick_deficits("bark coarse",
                                              torch.stack(rows), picks)
        fine = []
        for cb in range(2, cpu.fine_spec.n_codes_total):
            had = codes.clone()
            had[:, cb:] = 0  # the codebooks the card's forward saw
            lg = tb.bark_fine_logits(cpu.fine_spec, cpu.fine, had[None],
                                     cb)[0, :, :tb.CODEBOOK_SIZE]
            fine.append(_pick_deficits(f"bark fine {cb}", lg, codes[:, cb]))
        out["fine_greedy"] = {
            "tokens": sum(v["tokens"] for v in fine),
            "exact_argmax": sum(v["exact_argmax"] for v in fine),
            "worst_logit_deficit": max(v["worst_logit_deficit"]
                                       for v in fine),
            "tol": min(v["tol"] for v in fine)}
        out["held"] = _held("bark codec", audio, encodec_decode(
            cpu.codec, np.asarray(codes.T), cpu.ratios), TTS_AR_TOL)
    return out


def xtts_check(backend, model_path: Path, served, rec) -> dict:
    """The served XTTS-v2 request's stages (``rec``: host ms a token of
    the GPT, its codes and latents, the waveform), its served samples the
    card's waveform; device ms of one step and of HiFiGAN; the picks held
    to one teacher-forced forward on the CPU over the card's codes, the
    card's latents within ``TTS_AR_TOL`` of that forward's, and the
    card's latents through HiFiGAN on the CPU within ``TTS_AR_TOL``."""
    import torch

    from localai_tfp_tpu_torch.device import f32_products
    from localai_tfp_tpu_torch.models import xtts as tx

    spec, p, tok, voices = backend._xtts
    lat, emb = voices["ana"]
    ids = tx.text_ids(spec, tok, TTS_TEXT)
    dev = p["ln_f_w"].device
    (codes, lats), gpt_s = rec["gpt_generate"]
    audio, hifi_s = rec["hifigan_decode"]
    audio = audio.cpu().numpy()
    with torch.inference_mode(), f32_products():
        cond = torch.as_tensor(lat, device=dev)
        prefix = tx.gpt_prefix(spec, p, ids, cond)
        P = prefix.shape[1]
        caches = tx.new_caches(spec, p, P + 1)
        tx.gpt_forward(spec, p, prefix, caches, 0)
        step = p["audio_emb"][5] + p["audio_pos"][1]
        dm = {"gpt_step": _stage_ms(lambda: tx.gpt_forward(
                  spec, p, step[None, None], caches, P)),
              "hifigan": _stage_ms(lambda: tx.hifigan_decode(
                  spec, p, lats, emb))}
    n = len(codes)
    if n != spec.max_audio_tokens:
        raise AssertionError(f"tts_ar xtts: {n} codes, not "
                             f"{spec.max_audio_tokens}")
    out = {"text_ids": len(ids), "codes": n, "device_ms": dm,
           "host_ms_per_token": round(gpt_s * 1e3 / n, 4),
           "host_ms": {"hifigan": round(hifi_s * 1e3, 3)},
           "served_lsb": _served("xtts", served["elevenlabs"]["pcm"],
                                 audio)}
    cspec, cp, _, _ = tx.load_xtts(str(model_path), "cpu")
    with torch.inference_mode():
        cprefix = tx.gpt_prefix(cspec, cp, ids, torch.as_tensor(lat))
        audio_in = cp["audio_emb"][torch.as_tensor(codes)] \
            + cp["audio_pos"][1:n + 1]
        seq = torch.cat([cprefix, audio_in[None]], 1)
        hidden = tx.gpt_forward(cspec, cp, seq,
                                tx.new_caches(cspec, cp, seq.shape[1]), 0)[0]
        rows = tx.audio_logits(cspec, cp, hidden[P - 1:P - 1 + n])
        keep = [c for c in range(rows.shape[1])
                if c not in (spec.start_audio_token, spec.stop_audio_token)]
        out["greedy"] = _pick_deficits("xtts gpt", rows[:, keep],
                                       [keep.index(int(c)) for c in codes])
        out["latents"] = _held("xtts latents", lats.cpu().numpy(),
                               hidden[P:P + n].numpy(), TTS_AR_TOL)
        out["held"] = _held("xtts hifigan", audio, tx.hifigan_decode(
            cspec, cp, lats.cpu(), emb).numpy(), TTS_AR_TOL)
    return out


def musicgen_check(backend, model_path: Path, served_pcm, rec) -> dict:
    """The served greedy musicgen-small request's stages (``rec``: host
    ms a step, its frames, the waveform), its served samples the card's
    waveform; device ms of the encoder, one step and the codec; the picks
    held to one teacher-forced pass of the same model on the CPU (the
    guided logits at each codebook's frames), the card's frames decoded
    on the CPU within ``TTS_AR_TOL``."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.device import f32_products
    from localai_tfp_tpu_torch.models import musicgen as tm

    bundle, tok = backend._musicgen
    ids = (tok.encode_special(MUSICGEN_TEXT) if tok is not None else
           [b % bundle[0].vocab_size for b in MUSICGEN_TEXT.encode()])
    dec, meta = bundle[2], bundle[6]
    max_new = max(int(MUSICGEN_SECONDS * meta["frame_rate"]), 8) \
        + dec.n_codebooks - 1
    frames, mg_s = rec["mg_codes"]
    audio, codec_s = rec["decode_frames"]
    if frames.shape != (dec.n_codebooks, max_new + 1 - dec.n_codebooks):
        raise AssertionError(f"tts_ar musicgen: frames {frames.shape}")
    with torch.inference_mode(), f32_products():
        enc = tm.encode_text(bundle, ids, 3.0)
        cross = tm.mg_cross_kv(bundle[3], enc)
        shape = (dec.n_layers, 2, max_new + 1, dec.d_model)
        ck, cv = enc.new_zeros(shape), enc.new_zeros(shape)
        frame = torch.zeros((2, dec.n_codebooks), dtype=torch.long,
                            device=enc.device)
        dm = {"t5_encoder": _stage_ms(lambda: tm.encode_text(bundle, ids,
                                                             3.0)),
              "decoder_step": _stage_ms(lambda: tm.mg_step(
                  dec, bundle[3], frame, cross, ck, cv, max_new // 2)),
              "codec": _stage_ms(lambda: tm.decode_frames(bundle, frames))}
    out = {"text_ids": len(ids), "frames": frames.shape[1],
           "steps": max_new, "device_ms": dm,
           "host_ms_per_step": round(mg_s * 1e3 / max_new, 4),
           "host_ms": {"codec": round(codec_s * 1e3, 3)},
           "served_lsb": _served("musicgen", served_pcm, audio)}
    cpu = tm.load_musicgen(str(model_path), "cpu")
    valid = tm.delay_pattern(dec.n_codebooks, max_new)
    codes = np.full(valid.shape, meta["decoder_start"], np.int64)
    codes[valid] = frames.reshape(-1)
    # each step's input frame: the codes where the staircase has them,
    # the pad token elsewhere
    inputs = np.where(valid, codes, dec.pad_token)[:, :-1]
    with torch.inference_mode():
        x = torch.as_tensor(np.repeat(inputs[None], 2, 0))
        lg = tm.mg_decode_full(cpu[2], cpu[3], x,
                               tm.encode_text(cpu, ids, 3.0))
        guided = lg[1] + 3.0 * (lg[0] - lg[1])  # [nb, T, V]
        at = torch.as_tensor(valid[:, 1:])  # the picks that became frames
        out["greedy"] = _pick_deficits("musicgen decoder", guided[at],
                                       codes[:, 1:][valid[:, 1:]])
        out["held"] = _held("musicgen codec", audio,
                            tm.decode_frames(cpu, frames), TTS_AR_TOL)
    return out


def sound_requests(port: int, name: str) -> dict:
    """MusicGen behind its YAML through /v1/sound-generation at
    ``MUSICGEN_SECONDS``, sampled (the route's default, seed 0) and greedy
    (temperature 0): 200, audio/x-wav, 32 kHz, the frames' samples;
    request ms and real-time factor."""
    import math

    rate = ENCODEC_32KHZ["sampling_rate"]
    hop = math.prod(ENCODEC_32KHZ["upsampling_ratios"])
    frames = max(int(MUSICGEN_SECONDS * (rate // hop)), 8)
    out = {}
    for way, extra in (("sampled", {}), ("greedy", {"temperature": 0})):
        t0 = time.perf_counter()
        status, headers, data = _req(port, "POST", "/v1/sound-generation", {
            "model_id": name, "text": MUSICGEN_TEXT,
            "duration_seconds": MUSICGEN_SECONDS, **extra})
        ms = (time.perf_counter() - t0) * 1e3
        ctype = headers.get("Content-Type", "")
        if status != 200 or ctype != "audio/x-wav":
            raise AssertionError(f"tts_ar {name} {way}: {status} {ctype} "
                                 f"{data[:300]!r}")
        head, pcm = _wav_samples(data)
        if head != (1, 2, rate) or len(pcm) != frames * hop:
            raise AssertionError(f"tts_ar {name} {way}: header {head}, "
                                 f"{len(pcm)} samples for {frames} frames")
        seconds = len(pcm) / rate
        out[way] = {"request_ms": round(ms, 3), "audio_s": round(seconds, 3),
                    "rtf": round(ms / 1e3 / seconds, 4), "pcm": pcm}
    return out


def phase_tts_ar(smi: str, seed: int) -> dict:
    """bark-small, XTTS-v2 and musicgen-small at published widths (random
    weights from ``seed``) through the HTTP server: bark at the worker's
    defaults (temperature 0.7, 256 semantic tokens) by /tts and greedy
    (``temperature=0``: the coarse window slides) by /v1/audio/speech,
    XTTS greedy by /v1/audio/speech, /tts and /v1/text-to-speech/ana,
    MusicGen at 5 s with guidance by /v1/sound-generation, sampled (seed
    0) and greedy; request ms and real-time factor; each model's greedy
    stages held to the CPU (``bark_check``, ``xtts_check``,
    ``musicgen_check``), then unloaded: allocated bytes back within
    LC_SLACK of the baseline."""
    import shutil
    import threading

    import torch

    from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
    from localai_tfp_tpu_torch.config.model_config import Usecase
    from localai_tfp_tpu_torch.models import bark as tb
    from localai_tfp_tpu_torch.models import musicgen as tm
    from localai_tfp_tpu_torch.models import xtts as tx
    from localai_tfp_tpu_torch.server.app import Server
    from localai_tfp_tpu_torch.server.state import Application

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "tts_ar"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    t0 = time.perf_counter()
    written = {"bark": write_bark_dir(models / "bark-small", seed),
               "xtts": write_xtts_dir(models / "xtts-v2", seed + 1),
               "musicgen": write_musicgen_dir(models / "musicgen-small",
                                              seed + 2)}
    log("tts_ar_checkpoints", bytes=written,
        write_s=round(time.perf_counter() - t0, 3), card=smi)
    yamls = {
        "bark": {"backend": "bark", "parameters": {"model": "bark-small"}},
        "bark-greedy": {"backend": "bark",
                        "parameters": {"model": "bark-small"},
                        "options": ["temperature=0"]},
        "xtts": {"backend": "coqui", "parameters": {"model": "xtts-v2"}},
        "musicgen": {"backend": "tts",
                     "parameters": {"model": "musicgen-small"}},
    }
    for name, doc in yamls.items():
        (models / f"{name}.yaml").write_text(json.dumps({"name": name,
                                                         **doc}))
    out = {"checkpoint_bytes": written}
    base = _mem()
    srv = Server(Application(ApplicationConfig(
        models_path=str(models), address="127.0.0.1", port=0,
        generated_content_dir=str(models / "generated")), CARD))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        app = srv.app
        for name, routes in (("bark", ("tts",)), ("bark-greedy", ("speech",)),
                             ("xtts", ("speech", "tts", "elevenlabs")),
                             ("musicgen", None)):
            t_leg = time.perf_counter()
            # loaded first, so that a request's ms is the request's and
            # the served stages can be recorded on the loaded model
            backend = app.model_loader.load(app.config_loader.resolve(
                name, Usecase.SOUND_GENERATION if routes is None
                else Usecase.TTS))
            with _Recording({  # the last request's stages
                "bark-greedy": [(backend._bark, "semantic_tokens"),
                                (backend._bark, "coarse_tokens"),
                                (backend._bark, "fine_codes"),
                                (tb, "encodec_decode")],
                "xtts": [(tx, "gpt_generate"), (tx, "hifigan_decode")],
                "musicgen": [(tm, "mg_codes"), (tm, "decode_frames")],
            }.get(name, [])) as rec:
                if routes is None:
                    served = sound_requests(port, name)
                else:
                    served = tts_requests(port, name, "ana" if name == "xtts"
                                          else "", 24000, routes)
            leg = {"requests": {k: {kk: vv for kk, vv in v.items()
                                    if kk != "pcm"}
                                for k, v in served.items()}}
            lm = app.model_loader.get(name)
            leg["load_s"] = round(lm.load_s, 3)
            leg["family"] = backend.family()
            path = models / yamls[name]["parameters"]["model"]
            if name == "bark-greedy":
                leg.update(bark_check(backend._bark, path, served, rec.last))
            elif name == "xtts":
                leg.update(xtts_check(backend, path, served, rec.last))
            elif name == "musicgen":
                leg.update(musicgen_check(backend, path,
                                          served["greedy"]["pcm"], rec.last))
            loaded = _mem()
            del rec
            del backend, lm, served
            st, _, msg = _req(port, "POST", "/backend/shutdown",
                              {"model": name})
            if st != 200:
                raise AssertionError(f"tts_ar {name}: shutdown {st} {msg!r}")
            after = _mem()
            leg["memory"] = {"baseline": base["allocated"],
                             "loaded": loaded["allocated"],
                             "after_unload": after["allocated"],
                             "residue": _back(f"tts_ar {name}",
                                              after["allocated"], base)}
            leg["leg_s"] = round(time.perf_counter() - t_leg, 3)
            log(f"tts_ar_{name}", **leg, card=smi)
            out[name] = leg
    finally:
        _shut(srv, th)
        shutil.rmtree(models, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    log("tts_ar", phase_s=out["phase_s"], card=smi)
    return out


# ------------------------------------------------- phases weights, disagg
#
# Phase weights: the 8B (bf16, every layer) through the port's HTTP server
# with weight paging on (the default): a greedy chat hot, a demotion to the
# pinned host mirror (the slab's HBM unmapped and freed), the same chat
# again after the promotion (the same graphs replayed, no capture), the
# TTFT of a warm model against a hot one and a cold load; the int8 model
# (8 layers) from its artifact, bitwise across a seed demotion and its
# promotion; two models under a budget for
# one (the LRU demotes the idle one); the watchdog's demote mode.
# Phase disagg: the 8B at full width with LOCALAI_DISAGG=on against off:
# eight 1800-token prompts through /v1/chat/completions (greedy text equal,
# no prompt token re-prefilled by the decode engine, both pools clean),
# then the same eight as a flood beside four decoding streams (migrate
# GB/s, TTFT, the streams' ITL p50/p99).

WEIGHTS_CHAT = {"model": "llama-3.1-8b", "max_tokens": 24, "messages": [
    {"role": "user", "content": "Page the weights out and back in, then "
                                "tell me what you remember."}]}
DISAGG_PROMPTS = 8  # the flood's prompts, each DISAGG_TOKENS long
DISAGG_TOKENS = 1800
DISAGG_STREAMS_TOKENS = 96  # tokens each decoding stream emits


def _chat_text(port: int, body: dict) -> str:
    status, ctype, text = _http(port, body)
    check_reply(body["model"], body, status, ctype, text)
    return json.loads(text)["choices"][0]["message"]["content"]


def _graph_ids(eng) -> set:
    return {id(v.graph) for d in (eng._variants, eng._masked_variants,
                                  eng._mixed_variants, eng._spec_variants)
            for v in d.values()}


def _counts() -> dict:
    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    return {"ragged_paged_attention": ragged_paged_attention.launches,
            "int8_matmul": int8_matmul.launches}


def _zero_counts() -> None:
    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    ragged_paged_attention.launches = int8_matmul.launches = 0


def _demote(backend, limit: float = 120.0) -> dict:
    """Demote the worker's weights and wait for the warm state: the wall
    seconds and the free device memory (mem_get_info) before and
    after."""
    import torch

    pager = backend.engine._pager
    torch.cuda.synchronize()
    free0, _ = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    deadline = t0 + limit
    while backend.demote_weights() != "demoted":
        if time.perf_counter() > deadline:
            raise AssertionError(f"demotion never started ({pager.state})")
        time.sleep(0.01)
    if not pager.settle(limit) or pager.state != "warm":
        raise AssertionError(f"demotion did not land: {pager.stats()}")
    wall = time.perf_counter() - t0
    free1, _ = torch.cuda.mem_get_info()
    return {"wall_s": wall, "freed_bytes": free1 - free0,
            "outcome": pager.timings.get("demote_outcome"),
            "copy_s": pager.timings.get("demote_copy_s")}


def _first_token_ms(eng, text: str) -> float:
    """One greedy request's TTFT on the engine's clock (submit to first
    token), its completion drained."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    ev = eng.generate(GenRequest(
        prompt_ids=eng.tokenizer.encode(text, add_bos=True), max_tokens=4,
        ignore_eos=True))
    if ev.finish_reason != "length":
        raise AssertionError(f"ttft request: {ev.finish_reason} {ev.error}")
    return ev.timing_first_token_ms


def _tree_copy(params: dict) -> dict:
    from localai_tfp_tpu_torch.models.quant import QTensor

    return {k: (tuple(t.clone() for t in v) if isinstance(v, QTensor)
                else v.clone()) for k, v in params.items()}


def _tree_bitwise(params: dict, ref: dict) -> dict:
    """Leaves (both planes of an int8 leaf) bitwise equal to ``ref``."""
    from localai_tfp_tpu_torch.models.quant import QTensor

    same = bad = 0
    for k, want in ref.items():
        got = params[k]
        got = tuple(got) if isinstance(got, QTensor) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if _bitwise(g, w):
                same += 1
            else:
                bad += 1
    return {"planes_bitwise": same, "planes_differ": bad}


def _mirror_pinned(pager) -> bool:
    return all(t.is_pinned() for v in pager._host.values()
               for t in (tuple(v) if isinstance(v, tuple) else (v,)))


def weights_int8_leg(port: int, app, smi: str) -> dict:
    """The int8 8B cut at INT8_CUT_LAYERS layers, served from its
    artifact as a user's int8 model is: a first load quantizes on the
    card and writes the artifact, the model is unloaded, and the second
    load reads the artifact and seeds the pager's mirror with its planes.
    The first demotion is then a seed drop (no device bytes; the file
    mapping's planes pinned on the demotion's thread), the promotion
    streams from that mirror, and q and scale come back bitwise. Pinning
    maps about 0.2% of the mirror's bytes on the card (the bf16 leg's
    ``mirror_mapping_bytes``), so the seed drop frees at least 99% of the
    tree."""
    import gc
    import shutil

    import torch

    name = "llama-3.1-8b-int8-cut"
    body = {**WEIGHTS_CHAT, "model": name}
    cache = ROOT / "build" / "chip_smoke" / "weights_quant"
    shutil.rmtree(cache, ignore_errors=True)
    saved = os.environ.get("LOCALAI_QUANT_CACHE_DIR")
    os.environ["LOCALAI_QUANT_CACHE_DIR"] = str(cache)
    os.environ["LOCALAI_QUANT_ARTIFACTS"] = "on"
    try:
        first = _loaded(port, app, name)
        first_mode = first.load_mode
        text_quantized = _chat_text(port, body)
        del first
        app.model_loader.shutdown_model(name)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        backend = _loaded(port, app, name)
        artifact_load_s = time.perf_counter() - t0
    finally:
        os.environ["LOCALAI_QUANT_ARTIFACTS"] = "off"
        if saved is None:
            os.environ.pop("LOCALAI_QUANT_CACHE_DIR", None)
        else:
            os.environ["LOCALAI_QUANT_CACHE_DIR"] = saved
    eng = backend.engine
    pager = eng._pager
    seeded = pager.stats()["seeded"]
    pinned0 = _mirror_pinned(pager) if seeded else None
    tree = pager.tree_bytes()
    ref = _tree_copy(eng.params)
    text0 = _chat_text(port, body)
    dem = _demote(backend)
    dem["unmapped"] = not pager.slab.mapped
    pinned = _mirror_pinned(pager)
    _zero_counts()
    text1 = _chat_text(port, body)  # promotes from the mirror, then serves
    launched = _counts()
    promote = dict(pager.timings)
    bits = _tree_bitwise(eng.params, ref)
    del ref
    shutil.rmtree(cache, ignore_errors=True)
    out = {"first_load_mode": first_mode, "load_mode": backend.load_mode,
           "artifact_load_s": artifact_load_s, "seeded": seeded,
           "mirror_pinned_at_load": pinned0, "demote": dem,
           "mirror_pin_s": promote.get("mirror_pin_s"),
           "mirror_pinned": pinned,
           "promote": {"s": promote.get("promote_s"),
                       "map_s": promote.get("map_s"),
                       "stream_s": promote.get("stream_s"),
                       "gbs": tree / promote["stream_s"] / 1e9},
           "bits": bits, "text_equal": text1 == text0,
           "artifact_text_equal": text0 == text_quantized,
           "launches": launched, "tree_bytes": tree, "card": smi}
    log("weights_int8", **out)
    if (first_mode, backend.load_mode) != ("quantized", "artifact") \
            or not seeded or dem["outcome"] != "seed" or not pinned \
            or not dem["unmapped"] or dem["freed_bytes"] < 0.99 * tree \
            or bits["planes_differ"] or text1 != text0 \
            or text0 != text_quantized or not launched["int8_matmul"]:
        raise AssertionError(f"int8 round trip from the artifact: {out}")
    return out


def weights_lru_leg(port: int, app, smi: str) -> dict:
    """Two models under LOCALAI_WEIGHT_HBM_MB sized for one: promoting the
    int8 model (just demoted) demotes the idle bf16 one (the least
    recently used)."""
    from localai_tfp_tpu_torch.engine.weight_pager import COORD

    a = app.loaded()["llama-3.1-8b"]
    b = app.loaded()["llama-3.1-8b-int8-cut"]
    pa, pb = a.engine._pager, b.engine._pager
    if not pa.ensure_hot(120):
        raise AssertionError("bf16 model did not come back hot")
    budget = max(pa.tree_bytes(), pb.tree_bytes()) * 1.2
    os.environ["LOCALAI_WEIGHT_HBM_MB"] = f"{budget / (1 << 20):.3f}"
    try:
        if pb.state != "warm":
            _demote(b)
        before = COORD.counters["pressure_demotes"]
        pa.last_used = time.monotonic() - 60  # a idle, b the one wanted
        _first_token_ms(b.engine, "Wake the smaller model.")
        deadline = time.perf_counter() + 120
        while pa.state != "warm" and time.perf_counter() < deadline:
            time.sleep(0.01)
        out = {"budget_bytes": int(budget), "a_state": pa.state,
               "b_state": pb.state,
               "pressure_demotes": COORD.counters["pressure_demotes"]
               - before, "residency": COORD.residency(), "card": smi}
    finally:
        os.environ["LOCALAI_WEIGHT_HBM_MB"] = "0"
    if (out["a_state"], out["b_state"]) != ("warm", "hot") \
            or out["pressure_demotes"] < 1:
        raise AssertionError(f"LRU under pressure: {out}")
    a.engine.leak_check()
    b.engine.leak_check()
    log("weights_lru", **out)
    return out


def weights_watchdog_leg(app, smi: str) -> dict:
    """LOCALAI_WATCHDOG_DEMOTE=on and a short idle timeout: the idle hot
    int8 model is demoted, not unloaded."""
    from localai_tfp_tpu_torch.engine.loader import WatchDog

    name = "llama-3.1-8b-int8-cut"
    b = app.loaded()[name]
    pb = b.engine._pager
    if not pb.ensure_hot(120):
        raise AssertionError("int8 model did not come back hot")
    os.environ["LOCALAI_WATCHDOG_DEMOTE"] = "on"
    try:
        ml = app.model_loader
        ml.mark_idle(name)
        wd = WatchDog(ml, idle_timeout=1.0, enable_idle=True)
        killed = wd.check(time.monotonic() + 2.0)
        pb.settle(120)
    finally:
        os.environ["LOCALAI_WATCHDOG_DEMOTE"] = "off"
    # (the bf16 model, warm since the LRU leg and idle too, is unloaded:
    # a model idle while warm takes the kill path)
    out = {"killed": killed, "still_loaded": name in ml.loaded_names(),
           "state": pb.state, "card": smi}
    if name in killed or not out["still_loaded"] or pb.state != "warm":
        raise AssertionError(f"watchdog demote: {out}")
    log("weights_watchdog", **out)
    return out


def phase_weights(ckpt_name: str, smi: str) -> dict:
    """Weight paging on the card (see the block comment above)."""
    import torch

    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "models"
    model_yaml(models, "llama-3.1-8b", ckpt_name)
    cut = first_layers(models, ckpt_name, INT8_CUT_LAYERS)
    model_yaml(models, "llama-3.1-8b-int8-cut", cut, quantization="int8")
    os.environ["LOCALAI_QUANT_ARTIFACTS"] = "off"
    srv, th = _serve(models)
    port = srv.server_address[1]
    try:
        t0 = time.perf_counter()
        backend = _loaded(port, srv.app, "llama-3.1-8b")
        cold_s = time.perf_counter() - t0
        eng = backend.engine
        pager = eng._pager
        if pager is None:
            raise AssertionError("the served engine has no weight pager")
        tree = pager.tree_bytes()
        _zero_counts()
        text0 = _chat_text(port, WEIGHTS_CHAT)
        ttft_hot = _first_token_ms(eng, "A hot model answers at once.")
        variants, graphs = eng.variant_count(), _graph_ids(eng)
        from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT

        FLIGHT.clear()
        # the first demotion also pins the host mirror, whose mapping
        # takes device memory of its own (the card's page tables for the
        # pinned pages); the seed demotion below only unmaps the slab
        dem = _demote(backend)
        demote_alloc_s = pager.timings.get("mirror_alloc_s")
        mirror = pager.host_bytes()
        pinned = _mirror_pinned(pager)
        text1 = _chat_text(port, WEIGHTS_CHAT)  # promotes, then serves
        promote = dict(pager.timings)
        seed = _demote(backend)  # the mirror still matches: no copy
        if seed["freed_bytes"] < tree - pager.slab.granularity:
            raise AssertionError(f"an unmap freed {seed['freed_bytes']} B "
                                 f"of a {tree} B tree")
        ttft_warm = _first_token_ms(eng, "A hot model answers at once.")
        launched = _counts()
        trace = FLIGHT.export_chrome_trace()
        tracks = {ev["tid"]: ev["args"]["name"] for ev in trace["traceEvents"]
                  if ev.get("ph") == "M" and ev["name"] == "thread_name"}
        spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
        w = [ev for ev in spans if tracks.get(ev["tid"]) == "weights"]
        steps = [ev for ev in spans if ev["name"].startswith("step:")]
        overlap = sum(1 for b in w if b["args"]["blocking"] for st in steps
                      if st["ts"] < b["ts"] + b["dur"]
                      and b["ts"] < st["ts"] + st["dur"])
        mem_total = next(int(x.split()[1]) * 1024 for x in
                         open("/proc/meminfo") if x.startswith("MemTotal"))
        out = {
            "tree_bytes": tree, "slab_bytes": pager.slab.nbytes,
            "granularity": pager.slab.granularity,
            "demote": {**dem, "gbs": (tree / dem["copy_s"] / 1e9
                                      if dem["copy_s"] else None),
                       "mirror_alloc_s": demote_alloc_s},
            "promote": {"s": promote.get("promote_s"),
                        "map_s": promote.get("map_s"),
                        "stream_s": promote.get("stream_s"),
                        "gbs": tree / promote["stream_s"] / 1e9},
            "seed_demote": seed,
            # device memory the pinned mirror's mapping keeps
            "mirror_mapping_bytes": seed["freed_bytes"] - dem["freed_bytes"],
            "ttft_ms": {"hot": ttft_hot, "warm": ttft_warm,
                        "cold_load_and_first_request": cold_s * 1e3},
            "text_equal": text1 == text0,
            "variants": [variants, eng.variant_count()],
            "same_graphs": _graph_ids(eng) == graphs,
            "launches": launched,
            "w_spans": {n: sum(1 for e in w if e["name"] == n)
                        for n in sorted({e["name"] for e in w})},
            "blocking_w_spans": sum(1 for e in w if e["args"]["blocking"]),
            "steps_overlapping_blocking_w": overlap,
            "mirror_host_bytes": mirror, "mirror_pinned": pinned,
            "mem_total_bytes": mem_total,
            "pager": {k: v for k, v in pager.stats().items()
                      if k != "timings"}, "card": smi}
        log("weights_8b", **out)
        if not (out["text_equal"] and out["same_graphs"]
                and variants == eng.variant_count()
                and launched["ragged_paged_attention"] > 0
                and seed["outcome"] == "seed" and overlap == 0
                and out["blocking_w_spans"] == 0):
            raise AssertionError(f"weights round trip: {out}")
        eng.leak_check()
        del eng
        int8 = weights_int8_leg(port, srv.app, smi)
        lru = weights_lru_leg(port, srv.app, smi)
        wd = weights_watchdog_leg(srv.app, smi)
    finally:
        _shut(srv, th)
        os.environ["LOCALAI_QUANT_ARTIFACTS"] = "on"
    res = {"bf16": out, "int8": int8, "lru": lru, "watchdog": wd,
           "launches": {k: out["launches"][k] + int8["launches"][k]
                        for k in out["launches"]},
           "phase_s": time.perf_counter() - t_phase}
    log("weights", launches=res["launches"], phase_s=res["phase_s"],
        card=smi)
    torch.cuda.empty_cache()
    return res


def disagg_prompt(i: int) -> str:
    """A chat message of about DISAGG_TOKENS byte tokens, distinct per i."""
    import numpy as np

    rng = np.random.default_rng(100 + i)
    words = ["page", "migrate", "prefill", "decode", "stream", "token",
             "card", "slot", "host", "arena", "copy", "event"]
    text = f"Request {i}: " + " ".join(
        words[j] for j in rng.integers(0, len(words), DISAGG_TOKENS))
    return text[:DISAGG_TOKENS]


def flood_itl(target, decode, backend, prompts: list) -> dict:
    """DISPATCH_STREAMS greedy streams on ``decode`` (short prompts, the
    local path); once they decode, ``prompts`` arrive through ``target``
    (the router, or the plain engine itself). The streams' ITL (each
    dispatch's delivery gap over its tokens) p50/p99, the flood's TTFT."""
    from localai_tfp_tpu_torch.engine.engine import GenRequest

    streams = stream_requests(backend, DISAGG_STREAMS_TOKENS)
    times: dict = {r.id: [] for r in streams}
    emit = decode._emit_token

    def emit_(slot, tok, defer=False):
        if slot.request is not None and slot.request.id in times:
            times[slot.request.id].append((decode.metrics.forward_steps,
                                           time.perf_counter()))
        return emit(slot, tok, defer)

    decode._emit_token = emit_
    try:
        qs = target.submit_many(streams)
        while not all(times[r.id] for r in streams):
            time.sleep(0.001)
        flood = [GenRequest(prompt_ids=list(p), max_tokens=8,
                            ignore_eos=True) for p in prompts]
        fq = target.submit_many(flood)
        finals = []
        for q in fq + qs:
            ev = q.get(timeout=600)
            while not ev.done:
                ev = q.get(timeout=600)
            finals.append(ev)
    finally:
        del decode._emit_token
    bad = [f.finish_reason for f in finals if f.finish_reason != "length"]
    if bad:
        raise AssertionError(f"flood: {bad}")
    gaps = []
    for ts in times.values():
        groups: dict = {}
        for step, t in ts[1:]:
            groups[step] = (groups.get(step, (t, 0))[0],
                            groups.get(step, (t, 0))[1] + 1)
        prev = ts[0][1]
        for t, k in sorted(groups.values()):
            gaps.append((t - prev) * 1e3 / k)
            prev = t
    ttft = [f.timing_first_token_ms for f in finals[:len(flood)]]
    return {"itl_p50_ms": _pct(gaps, 0.5), "itl_p99_ms": _pct(gaps, 0.99),
            "itl_samples": len(gaps), "ttft_p50_ms": _pct(ttft, 0.5),
            "ttft_max_ms": max(ttft)}


def disagg_arm(models: Path, on: bool, smi: str) -> dict:
    """One arm of phase disagg on its own server: the eight chats through
    HTTP at once, then the flood beside the streams."""
    import threading

    os.environ["LOCALAI_DISAGG"] = "on" if on else "off"
    srv, th = _serve(models)
    port = srv.server_address[1]
    try:
        backend = _loaded(port, srv.app, "llama-3.1-8b")
        eng = backend.engine
        decode = eng.decode if on else eng
        bodies = [{"model": "llama-3.1-8b", "max_tokens": 16, "messages": [
            {"role": "user", "content": disagg_prompt(i)}]}
            for i in range(DISAGG_PROMPTS)]
        texts: list = [None] * len(bodies)
        prefill0 = decode.metrics.prefill_tokens
        adopt0 = (decode._migrator.counters["adoptions"] if on else 0)

        def post(i):
            texts[i] = _chat_text(port, bodies[i])

        ths = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        chat = {"texts": texts,
                "decode_prefill_tokens": decode.metrics.prefill_tokens
                - prefill0}
        if on:
            chat["adoptions"] = decode._migrator.counters["adoptions"] \
                - adopt0
        from localai_tfp_tpu_torch.telemetry.flightrec import FLIGHT

        FLIGHT.clear()
        prompts = [backend.tokenizer.encode(disagg_prompt(100 + i),
                                            add_bos=True)
                   for i in range(DISAGG_PROMPTS)]
        _zero_counts()
        adopt0 = decode._migrator.counters["adoptions"] if on else 0
        prefill0 = decode.metrics.prefill_tokens
        flood = flood_itl(eng, decode, backend, prompts)
        flood["launches"] = _counts()
        # (the decode engine's pool holds 8 slots' pages: a flood beside
        # four streams may leave a handoff no pages, and it re-prefills)
        flood["decode_prefill_tokens"] = (decode.metrics.prefill_tokens
                                          - prefill0)
        if on:
            flood["adoptions"] = (decode._migrator.counters["adoptions"]
                                  - adopt0)
        if on:
            trace = FLIGHT.export_chrome_trace()
            tracks = {ev["tid"]: ev["args"]["name"]
                      for ev in trace["traceEvents"]
                      if ev.get("ph") == "M" and ev["name"] == "thread_name"}
            mig = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"
                   and tracks.get(ev["tid"]) == "migrate"]
            for name in ("kv:migrate_out", "kv:migrate_in"):
                sp = [ev for ev in mig if ev["name"] == name]
                b = sum(ev["args"]["bytes"] for ev in sp)
                us = sum(ev["dur"] for ev in sp)
                flood[name] = {"spans": len(sp), "bytes": b,
                               "gbs": b / us / 1e3 if us else None,
                               "blocking": sum(ev["args"]["blocking"]
                                               for ev in sp)}
            time.sleep(0.2)
            eng.leak_check()  # both pools, and the interchange
            bus, mig = eng.bus.counters, decode._migrator.counters
            flood["bus"] = dict(bus)
            flood["d2h_gbs"] = (bus["d2h_bytes"] / bus["d2h_ms"] / 1e6
                                if bus["d2h_ms"] else None)
            flood["h2d_gbs"] = (mig["h2d_bytes"] / mig["h2d_ms"] / 1e6
                                if mig["h2d_ms"] else None)
        else:
            eng.leak_check()
        out = {"chat": chat, "flood": flood, "card": smi}
        log("disagg_" + ("on" if on else "off"),
            **{k: v for k, v in out.items() if k != "chat"},
            chat={k: v for k, v in chat.items() if k != "texts"})
        return out
    finally:
        _shut(srv, th)
        os.environ["LOCALAI_DISAGG"] = "off"


def phase_disagg(ckpt_name: str, smi: str) -> dict:
    """Disaggregated serving on the card, on against off."""
    t_phase = time.perf_counter()
    models = ROOT / "build" / "chip_smoke" / "models"
    model_yaml(models, "llama-3.1-8b", ckpt_name)
    off = disagg_arm(models, False, smi)
    on = disagg_arm(models, True, smi)
    same = [a == b for a, b in zip(on["chat"]["texts"], off["chat"]["texts"])]
    res = {"text_equal": same, "off": off, "on": on,
           "launches": on["flood"]["launches"],
           "phase_s": time.perf_counter() - t_phase}
    log("disagg", text_equal=same,
        itl_ms={"on": [on["flood"]["itl_p50_ms"], on["flood"]["itl_p99_ms"]],
                "off": [off["flood"]["itl_p50_ms"],
                        off["flood"]["itl_p99_ms"]]},
        ttft_p50_ms={"on": on["flood"]["ttft_p50_ms"],
                     "off": off["flood"]["ttft_p50_ms"]},
        launches=res["launches"], phase_s=res["phase_s"], card=smi)
    log("disagg_migration", d2h_gbs=on["flood"]["d2h_gbs"],
        h2d_gbs=on["flood"]["h2d_gbs"], bus=on["flood"]["bus"], card=smi)
    if not all(same) or on["chat"]["decode_prefill_tokens"] != 0 \
            or on["chat"]["adoptions"] != DISAGG_PROMPTS:
        raise AssertionError(f"disagg: text equal {same}, decode prefill "
                             f"{on['chat']['decode_prefill_tokens']}, "
                             f"adoptions {on['chat'].get('adoptions')}")
    return res


def main() -> int:
    """Run the phases; a phase that raises prints one line naming itself
    (``{"phase_failed": ...}``) before the run exits non-zero."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="device,build,kernels,int8,moe,gguf,main,graphs,"
                            "engine,dispatch,tiers,weights,disagg,spec,text,"
                            "lifecycle,families,recurrent_vision,retrieval,"
                            "audio,tts,tts_ar")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the main-path model (8B: 32)")
    ap.add_argument("--gguf-layers", type=int, default=None,
                    help="depth of phase gguf's 8B file (default: all 32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    at = {"phase": "start"}
    try:
        return run_phases(args, at)
    except BaseException as e:
        print(json.dumps({"phase_failed": at["phase"],
                          "t_s": round(time.perf_counter() - T0, 3),
                          "error": repr(e)[:4000]}), flush=True)
        raise


def run_phases(args, at: dict) -> int:
    """The phases of ``args.phases`` in their order; ``at["phase"]``
    names the one running."""
    phases = set(args.phases.split(","))
    require_package()
    at["phase"] = "device"
    dev, smi = phase_device()
    build = occupancy = occ8 = None
    if "build" in phases:
        at["phase"] = "build"
        build, occupancy, occ8 = phase_build()
    entries = []
    # each kernel: correctness first, then times at 8B shapes
    if "kernels" in phases:
        at["phase"] = "kernels"
        worst, timings, aliased, spec_err = phase_kernels(
            n_slots=SLOTS, max_pages=CONTEXT // PAGE)
        fam_worst, fam_keys = family_kernel_keys()
        t = timings["decode"]
        entries.append({
            "name": "ragged_paged_attention", "route": "cuda",
            "source": "localai_tfp_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "localai_tfp_tpu/ops/ragged_paged_attention.py:68",
            "launches": None,
            "max_abs_err": max(max(worst.values()), fam_worst),
            "max_abs_err_bf16": worst["bf16"],
            "max_abs_err_int8": worst["int8"], "tol": TOL,
            "aliased_tables_max_abs_err": aliased,
            "spec_keys_max_abs_err": spec_err,
            "ms": t["ms"], "eager_ms": t["eager_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": "decode",
            "timing": "cold: layers cycled past the L2; ms by CUDA-graph "
                      "replay, eager_ms call by call",
            **{f"{mix}_step": {k: timings[mix][k] for k in (
                "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
               for mix in ("mixed", "chunk512", "verify", "draft_decode")},
            # the dense families' keys (FAMILY_KEYS)
            "family_keys": fam_keys,
        })
        if build is not None:
            rows = build["ragged_paged_attention"]
            entries[-1].update(
                registers={r["entry"]: r["registers"] for r in rows},
                spill_bytes=sum(r["spill_bytes"] for r in rows),
                blocks_per_sm={f"{o['q']}/{o['kv']}/dh{o['dh']}/bm{o['bm']}":
                               o["blocks_per_sm"] for o in occupancy})
    if "int8" in phases:
        at["phase"] = "int8"
        worst8, t8 = phase_int8_kernels()
        t = t8["w_gate_m8"]
        cols = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bf16_matmul_ms", "eager_ms", "plan", "other_tile")
        entries.append({
            "name": "int8_matmul", "route": "cuda",
            "source": "localai_tfp_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "localai_tfp_tpu/ops/int8_matmul.py:32",
            "launches": None,
            "max_abs_err": worst8["abs_f32out"],
            "max_abs_err_bf16out": worst8["abs_bf16out"],
            "max_rel_err_f32out": worst8["rel_f32out"],
            "max_ulps_bf16out": worst8["ulp_bf16out"],
            "max_rel_err_beyond_1ulp_bf16out": worst8["excess_bf16out"],
            "tol": f"f32 out {INT8_REL_TOL} x max|want|; bf16 out 1 ulp "
                   f"+ {INT8_REL_TOL} x max|want|",
            **{k: t[k] for k in cols}, "shape": "w_gate_m8",
            "timing": "cold: operand copies past the L2; ms by CUDA-graph "
                      "replay, eager_ms call by call",
            **{f"{name}_m{m}": {k: t8[f"{name}_m{m}"][k] for k in cols}
               for name, m in INT8_TIMED[1:]},
            "layer_m1024": t8["layer_m1024"],
        })
        if build is not None:
            rows = build["int8_matmul"]
            entries[-1].update(
                registers={r["entry"]: r["registers"] for r in rows},
                spill_bytes=sum(r["spill_bytes"] for r in rows),
                blocks_per_sm={o["instance"]: o["blocks_per_sm"]
                               for o in occ8},
                smem_bytes={o["instance"]: o["smem_bytes"] for o in occ8})
    # phases moe and gguf run before main: a call may write 45 GiB to its
    # machine's disk, and the file system reuses the blocks of a removed
    # file, so the disk holds at most the largest set of files alive at
    # once. Written first and each removed after it is served, their
    # checkpoints (28.6 GB for Qwen1.5-MoE) never sit beside the 8B
    # phases' ~35 GB (checkpoint, int8 artifact, draft, a family model)
    for name, run in (("moe", phase_moe), ("gguf", phase_gguf)):
        if name not in phases:
            continue
        at["phase"] = name
        legs = (run(smi, args.seed, args.gguf_layers) if name == "gguf"
                else run(smi, args.seed))
        for e in entries:
            # each leg's streamed burst, its counts set to 0 just before
            # it and read just after
            e[f"launches_{name}"] = {
                k: v["burst"]["launches"][e["name"]]
                for k, v in legs.items() if isinstance(v, dict)}
            if e["name"] == "int8_matmul" and name == "gguf":
                e["launches_gguf_int8_by_m"] = legs["llama31_8b_int8"][
                    "burst"]["int8_matmul_calls_by_m"]
    for ph in ("graphs", "engine", "dispatch", "tiers", "spec", "text"):
        if ph in phases and "main" not in phases:
            raise SystemExit(f"phase {ph} runs after phase main (its "
                             "checkpoint and int8 artifact): --phases must "
                             "include main")
    if "main" in phases:
        at["phase"] = "main"
        res = phase_main(args.layers, args.seed, "engine" in phases,
                         "graphs" in phases, "dispatch" in phases,
                         "tiers" in phases)
        # each kernel's count on its own path, read just after that path
        # ran: attention on the bf16 model, the int8 product on the int8
        # model (which also runs attention)
        own = {"ragged_paged_attention": res["bf16"]["burst"]["launches"],
               "int8_matmul": res["int8"]["burst"]["launches"]}
        for e in entries:
            e["launches"] = own[e["name"]][e["name"]]
            e["launches_int8_model"] = \
                res["int8"]["burst"]["launches"][e["name"]]
            if "graphs" in phases:
                # phase graphs' wave: per replay (graph) and per call
                # (the variant body eagerly at its bucket, the eager loop)
                e["launches_graphs_wave"] = {
                    m: res[m]["graphs"]["launches"] for m in ("bf16", "int8")}
            if "dispatch" in phases:
                # phase dispatch (a): the burst beside four decoding
                # streams, by replay (graph) and per call (the variant
                # bodies eagerly, the eager paths)
                e["launches_dispatch_wave"] = {
                    m: {w: res[m]["dispatch"]["mixed"][w]["launches"][
                        e["name"]] for w in DISPATCH_MODES}
                    for m in ("bf16", "int8")}
            if "tiers" in phases:
                # phase tiers' returning waves, each's counts set to 0
                # just before it and read just after: B1 per replay (the
                # prefetch-hit and resident waves) against per call (the
                # resident wave through the variant bodies), on the bf16
                # model; the int8 model's (int8 pages) hit wave
                key = ("b1_launches" if e["name"] == "ragged_paged_attention"
                       else "b2_launches")
                ret = res["bf16"]["tiers"]["returning"]
                e["launches_tiers"] = {
                    **{way: ret[way][key] for way in (
                        "prefetch_hit", "resident", "resident_per_call",
                        "cold")},
                    "int8_model_hit": res["int8"]["tiers"]["hit"][key]}
            if "engine" in phases:
                # the prefix wave with sharing on: attention over aliased
                # page tables (bf16 model), the int8 product's mixed
                # steps beside them (int8 model)
                e["launches_engine_prefix_wave"] = {
                    m: res[m]["engine"]["on"]["launches"][e["name"]]
                    for m in ("bf16", "int8")}
    if "main" in phases:
        ckpt = res["checkpoint"]
    elif {"weights", "disagg"} & phases:
        # phase main's checkpoint, written here when it is missing
        models = ROOT / "build" / "chip_smoke" / "models"
        layers = choose_depth(args.layers, models)
        ckpt = f"llama31-8b-geometry-L{layers}-s{args.seed}"
        write_checkpoint(models / ckpt, layers, args.seed)
    for name, run in (("weights", phase_weights), ("disagg", phase_disagg)):
        if name not in phases:
            continue
        at["phase"] = name
        out = run(ckpt, smi)
        for e in entries:
            # the phase's requests, their counts set to 0 just before
            # them and read just after
            e[f"launches_{name}"] = out["launches"][e["name"]]
    if "spec" in phases:
        at["phase"] = "spec"
        sp = phase_spec(res["checkpoint"], args.seed)
        # each run's counts, set to 0 just before it and read just after
        runs = {"a_spec": sp["a"]["spec"], "b_self_greedy": sp["b"]["greedy"],
                "b_self_sampled": sp["b"]["sampled"],
                "c_int8_one": sp["c"]["one"], "c_int8_eight": sp["c"]["eight"],
                "d_pair": sp["d"]["pair"]}
        for e in entries:
            e["launches_spec"] = {k: r["launches"][e["name"]]
                                  for k, r in runs.items()}
            # spec graphs: per replay (graph) against per call (the
            # variant bodies eagerly), each wave's counts
            e["launches_spec_graphs"] = {
                k: {m: [w["launches"][e["name"]] for w in pair[m]]
                    for m in SPEC_MODES}
                for k, pair in (("a", sp["a_graphs"]), ("b", sp["b"]),
                                ("c", sp["c"]["graphs"]))}
            if e["name"] == "int8_matmul":
                e["launches_spec_by_instance"] = {
                    k: b2_instances(runs[k]["int8_matmul_calls_by_m"])
                    for k in ("c_int8_one", "c_int8_eight")}
    if "text" in phases:
        from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul

        int8_matmul.launches = 0
        at["phase"] = "text"
        tx = phase_text(res["checkpoint"], res["bf16"]["byte_ttft"], smi)
        log("text", **tx)
        for e in entries:
            # the bf16 8B behind the BPE tokenizer: attention only
            e["launches_text"] = (tx["ragged_paged_attention_launches"]
                                  if e["name"] == "ragged_paged_attention"
                                  else int8_matmul.launches)
    if "lifecycle" in phases:
        from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
        from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
            ragged_paged_attention,
        )

        if "main" in phases:
            ckpt, layers = res["checkpoint"], res["layers"]
        else:  # phase main's checkpoint, written here when it is missing
            models = ROOT / "build" / "chip_smoke" / "models"
            layers = choose_depth(args.layers, models)
            ckpt = f"llama31-8b-geometry-L{layers}-s{args.seed}"
            write_checkpoint(models / ckpt, layers, args.seed)
        for f in (ragged_paged_attention, int8_matmul):
            f.launches = 0
        at["phase"] = "lifecycle"
        lc = phase_lifecycle(ckpt, layers, smi)
        launched = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
        log("lifecycle", launches=launched, phase_s=lc["phase_s"], card=smi)
        for e in entries:
            # the whole phase (a load's warmup restores the counts, so
            # these are the requests' launches, the embeddings' included)
            e["launches_lifecycle"] = launched[e["name"]]
    if "families" in phases:
        from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
        from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
            ragged_paged_attention,
        )

        at["phase"] = "families"
        fam = phase_families(smi, args.seed)
        for e in entries:
            # each model's streamed burst, its counts set to 0 just before
            # it and read just after (B2: the int8 Gemma 3's)
            e["launches_families"] = {
                k: v["burst"]["launches"][e["name"]]
                for k, v in fam.items() if isinstance(v, dict)}
            e["launches_families"]["gemma3_4b_int8"] = \
                fam["gemma3_4b"]["int8"]["burst"]["launches"][e["name"]]
            # the image chats (two images, another image), their counts
            # set to 0 just before them and read just after
            e["launches_families_images"] = {
                "gemma3_4b": fam["gemma3_4b"]["after"]["launches"][e["name"]],
                "gemma3_4b_int8": fam["gemma3_4b"]["int8"]["after"][
                    "launches"][e["name"]]}
    if "recurrent_vision" in phases:
        at["phase"] = "recurrent_vision"
        rv = phase_recurrent_vision(smi, args.seed)
        for e in entries:
            # LLaVA's burst and image chats, each's counts set to 0 just
            # before it and read just after; Mamba and RWKV run neither
            # kernel (no Pallas kernel in the JAX package either)
            e["launches_recurrent_vision"] = {
                "llava15_7b_burst": rv["llava15_7b"]["burst"]["launches"][
                    e["name"]],
                "llava15_7b_images": rv["llava15_7b"]["after"]["launches"][
                    e["name"]]}
    if "retrieval" in phases:
        from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
        from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
            ragged_paged_attention,
        )

        for f in (ragged_paged_attention, int8_matmul):
            f.launches = 0
        at["phase"] = "retrieval"
        phase_retrieval(smi, args.seed)
        launched = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
        for e in entries:
            # the encoders and the stores run neither kernel: the JAX
            # encoder and store have no Pallas kernel either
            e["launches_retrieval"] = launched[e["name"]]
    if "audio" in phases:
        from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
        from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
            ragged_paged_attention,
        )

        for f in (ragged_paged_attention, int8_matmul):
            f.launches = 0
        at["phase"] = "audio"
        phase_audio(smi, args.seed)
        launched = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
        for e in entries:
            # Whisper and the VAD run neither kernel: the JAX audio
            # networks have no Pallas kernel either
            e["launches_audio"] = launched[e["name"]]
    if "tts" in phases:
        at["phase"] = "tts"
        tts = phase_tts(smi, args.seed)
        for e in entries:
            # OuteTTS's served requests (its LM through the paged engine),
            # the counts set to 0 just before them and read just after;
            # VITS, piper and Kokoro run neither kernel (no Pallas kernel
            # in the JAX package either)
            e["launches_tts"] = tts["oute"]["launches"][e["name"]]
    if "tts_ar" in phases:
        from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
        from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
            ragged_paged_attention,
        )

        for f in (ragged_paged_attention, int8_matmul):
            f.launches = 0
        at["phase"] = "tts_ar"
        phase_tts_ar(smi, args.seed)
        launched = {"ragged_paged_attention": ragged_paged_attention.launches,
                    "int8_matmul": int8_matmul.launches}
        for e in entries:
            # bark, XTTS and MusicGen run neither kernel: their JAX loops
            # reach no Pallas kernel either
            e["launches_tts_ar"] = launched[e["name"]]
    if "softcap_witness" in phases:
        at["phase"] = "softcap_witness"
        phase_softcap_witness(smi, args.seed)
    at["phase"] = "report"
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
