"""The metric families the port records: the subset of
localai_tfp_tpu/telemetry/metrics.py that its layers fill, with the
reference's names, label names and buckets, so a dashboard built on the
JAX server reads the port's ``/metrics`` unchanged. Help strings are
the reference's except where the reference names a mechanism the port
does not have (XLA's cost analysis, jit variants, the persistent
compile cache): ``REWORDED`` lists those families.

Layer map (where each family is recorded):
- HTTP    server/app.py (``API_CALL``, keyed by matched route template)
- engine  engine/engine.py scheduler (host-held values only — no device
          sync rides a metric sample); the gauges are refreshed at
          scrape time by ``LLMEngine.update_gauges``
- device  telemetry/costmodel.py (FLOPs, bytes, MFU, predictions),
          telemetry/hbm_ledger.py (device memory by component) and
          utils/sysinfo.py (device memory and process RSS, refreshed by
          the server's gauge loop)
- loader  engine/loader.py (loads, load phases, evictions, the
          loaded and busy counts, watchdog kills)
- kv tier engine/kv_tier.py (moves, prefetch outcomes, bytes, pages
          per tier)
- weights engine/weight_pager.py (pages per tier, page moves, promotion
          outcomes, models per residency state)
- disagg  engine/kv_migrate.py (requests by path, migrated pages, the
          migrate stage, stage times)
- debug   utils/faultinject.py (faults delivered), telemetry/tracing.py
          (trace entries dropped), telemetry/flightrec.py (timeline ring)

Not ported yet: the families of federation.
"""

from __future__ import annotations

from .registry import REGISTRY

# sub-millisecond ladder for per-token / per-step series; the default
# ladder (1ms..60s) fits request-scale latencies
_STEP_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

# ------------------------------------------------------------------ HTTP

API_CALL = REGISTRY.histogram(
    "api_call_seconds",
    "HTTP API call latency by method and matched route template",
    labels=("method", "path"),
    max_label_sets=128,
    overflow={"path": "other"},
)

# ---------------------------------------------------------------- engine

ENGINE_QUEUE_WAIT = REGISTRY.histogram(
    "engine_queue_wait_seconds",
    "Time a request spent queued before slot admission",
    labels=("model",),
)
ENGINE_TTFT = REGISTRY.histogram(
    "engine_ttft_seconds",
    "Submit-to-first-token latency per request",
    labels=("model",),
)
ENGINE_PREFILL = REGISTRY.histogram(
    "engine_prefill_seconds",
    "Prompt-processing (prefill) time per request",
    labels=("model",),
)
ENGINE_INTER_TOKEN = REGISTRY.histogram(
    "engine_inter_token_seconds",
    "Mean inter-token latency per harvested decode scan",
    labels=("model",), buckets=_STEP_BUCKETS,
)
ENGINE_DECODE_STEP = REGISTRY.histogram(
    "engine_decode_step_seconds",
    "Device time per decode step (saturated-pipeline samples only)",
    labels=("model",), buckets=_STEP_BUCKETS,
)
ENGINE_QUEUE_DEPTH = REGISTRY.gauge(
    "engine_queue_depth_count",
    "Requests queued awaiting a slot",
    labels=("model",),
)
ENGINE_SLOTS_BUSY = REGISTRY.gauge(
    "engine_slots_busy_count",
    "Slots occupied by an active request (batch occupancy)",
    labels=("model",),
)
ENGINE_KV_UTIL = REGISTRY.gauge(
    "engine_kv_slot_utilization_ratio",
    "Fraction of KV-cache positions held by active slots",
    labels=("model",),
)
ENGINE_REQUESTS = REGISTRY.counter(
    "engine_requests_total",
    "Completed engine requests by finish reason",
    labels=("model", "reason"),
)
ENGINE_CANCELLATIONS = REGISTRY.counter(
    "engine_cancellations_total",
    "Cancellation records by outcome (client = a request was cancelled "
    "while queued or in flight, expired = a race-ahead cancel id aged "
    "out of the pending-cancel set without ever matching a request)",
    labels=("model", "reason"),
)
ENGINE_PROMPT_TOKENS = REGISTRY.counter(
    "engine_prompt_tokens_total",
    "Prompt tokens processed through prefill",
    labels=("model",),
)
ENGINE_GENERATED_TOKENS = REGISTRY.counter(
    "engine_generated_tokens_total",
    "Tokens sampled and emitted to streams",
    labels=("model",),
)
ENGINE_PREFIX_REUSED_TOKENS = REGISTRY.counter(
    "engine_prefix_reused_tokens_total",
    "Prompt tokens served from KV-resident prefixes instead of prefill "
    "(source: resident = destination slot already held them, copy = "
    "row-to-row on-device copy from another slot, disk = on-disk "
    "prompt cache restore)",
    labels=("model", "source"),
)
ENGINE_PREFIX_COPIES = REGISTRY.counter(
    "engine_prefix_copies_total",
    "On-device cross-slot KV prefix row copies dispatched",
    labels=("model",),
)
ENGINE_PROMPT_CACHE_RESTORES = REGISTRY.counter(
    "engine_prompt_cache_restores_total",
    "On-disk prompt cache restore attempts by result (restored/stale/"
    "shape_mismatch/dtype_mismatch/error/skipped_multihost/"
    "skipped_draft/no_file)",
    labels=("model", "result"),
)
ENGINE_KV_PAGES_IN_USE = REGISTRY.gauge(
    "engine_kv_pages_in_use_count",
    "Distinct KV pool pages currently allocated (arena occupancy; the "
    "trash page is excluded)",
    labels=("model",),
)
ENGINE_DISPATCH_VARIANTS = REGISTRY.gauge(
    "engine_dispatch_compile_variants_count",
    "Decode dispatch variants (one CUDA graph per row bucket) captured "
    "by the last completed engine warmup pass; 0 until warmup runs",
    labels=("model",),
)
ENGINE_WARMUP_SECONDS = REGISTRY.gauge(
    "engine_warmup_seconds",
    "Wall seconds of the last engine warmup pass by mode (cold = every "
    "decode variant's CUDA graph was captured)",
    labels=("model", "mode"),
)

# ------------------------------------------------------------ resilience

ENGINE_REQUESTS_SHED = REGISTRY.counter(
    "engine_requests_shed_total",
    "Requests refused at admission by the bounded queue "
    "(queue_full = LOCALAI_MAX_QUEUE exceeded at submit)",
    labels=("model", "reason"),
)
ENGINE_DEADLINE_EXCEEDED = REGISTRY.counter(
    "engine_deadline_exceeded_total",
    "Requests terminated by their deadline, by the stage they were in "
    "when it expired (queued = still in _pending, decode = already "
    "holding a slot)",
    labels=("model", "stage"),
)

# -------------------------------------------------------- observability

ENGINE_DEVICE_STEP = REGISTRY.histogram(
    "engine_device_step_seconds",
    "Device time per dispatch by kind (mixed/decodek/spec/spec_s), from "
    "a pair of CUDA events read where the engine already reads the "
    "dispatch's tokens back, so the sample costs no device sync",
    labels=("model", "kind"), buckets=_STEP_BUCKETS,
)
ENGINE_DEVICE_FLOPS = REGISTRY.counter(
    "engine_device_flops_total",
    "Device FLOPs accounted per dispatch kind from the analytic cost "
    "model (telemetry/costmodel.py) — accumulated host-side at harvest, "
    "zero hot-path syncs",
    labels=("model", "kind"),
)
ENGINE_DEVICE_BYTES = REGISTRY.counter(
    "engine_device_bytes_total",
    "Device bytes accessed (HBM traffic) accounted per dispatch kind "
    "from the analytic cost model",
    labels=("model", "kind"),
)
ENGINE_MFU = REGISTRY.gauge(
    "engine_mfu_ratio",
    "EWMA model-FLOPs-utilization: cost-model FLOPs per harvested "
    "flight divided by (device-step span x peak FLOPs across the mesh)",
    labels=("model",),
)
ENGINE_DISPATCH_PREDICTED = REGISTRY.histogram(
    "engine_dispatch_predicted_seconds",
    "Predicted device time per dispatch from the cost-model device-"
    "time predictor (telemetry/costmodel.py predict_ms) — observed at "
    "harvest next to engine_device_step_seconds, so the two "
    "distributions overlay on one dashboard",
    labels=("model", "kind"), buckets=_STEP_BUCKETS,
)
ENGINE_DISPATCH_PREDICTED_RATIO = REGISTRY.histogram(
    "engine_dispatch_predicted_ratio",
    "Predicted / measured device time per harvested dispatch — the "
    "predictor's live calibration error (1.0 = perfect; drift away "
    "from 1 means the per-kind calibration EWMA is stale)",
    labels=("model", "kind"),
    buckets=(0.125, 0.25, 0.5, 0.8, 1.0, 1.25, 2.0, 4.0, 8.0),
)
ENGINE_HBM_BYTES = REGISTRY.gauge(
    "engine_hbm_bytes",
    "Component-level HBM ledger (telemetry/hbm_ledger.py): bytes "
    "attributed to weights / kv_arena / kv_scales / draft_cache / "
    "staging / sampler, plus an 'unattributed' drift row reconciled "
    "against device.memory_stats()",
    labels=("model", "component"),
)
DEVICE_HBM_USED = REGISTRY.gauge(
    "device_hbm_used_bytes",
    "Per-device bytes the caching allocator holds "
    "(torch.cuda.memory_reserved), refreshed at each /metrics scrape "
    "and by utils/sysinfo.update_memory_gauges()",
    labels=("device",), max_label_sets=256,
)
PROCESS_RSS = REGISTRY.gauge(
    "process_rss_bytes",
    "Resident set size of the serving process (host RAM pressure; "
    "includes the KV host-spill tier)",
)

# ---------------------------------------------------------------- loader

MODEL_LOADS = REGISTRY.counter(
    "model_loads_total",
    "Backend model loads by outcome",
    labels=("model", "result"),
)
MODEL_LOAD_PHASE = REGISTRY.counter(
    "model_load_phase_seconds_total",
    "Cumulative load wall time by phase (the worker's load_breakdown: "
    "read, warmup, other)",
    labels=("phase",),
)
MODEL_EVICTIONS = REGISTRY.counter(
    "model_evictions_total",
    "Model unloads by reason (api/watchdog/single_active/shutdown)",
    labels=("reason",),
)
MODELS_LOADED = REGISTRY.gauge(
    "models_loaded_count",
    "Live loaded backends",
)

# --------------------------------------------------------------- workers

MODELS_BUSY = REGISTRY.gauge(
    "models_busy_count",
    "Loaded backends currently serving at least one request",
)
WATCHDOG_KILLS = REGISTRY.counter(
    "watchdog_kills_total",
    "Models killed by the busy/idle watchdog",
    labels=("kind",),
)

# ---------------------------------------------------------------- KV tiers
# engine/kv_tier.py: hot device pages, warm pinned-host pages, cold
# on-disk sessions
ENGINE_KV_TIER_PAGES = REGISTRY.gauge(
    "engine_kv_tier_pages_count",
    "KV pages resident per tier (hbm = pool pages allocated, host = "
    "spilled pages held in host RAM, disk = pages of cold sessions in "
    "the on-disk prompt-cache format)",
    labels=("model", "tier"),
)
ENGINE_KV_TIER_MOVES = REGISTRY.counter(
    "engine_kv_tier_moves_total",
    "Tier transitions by direction (spill = HBM->host, fetch = "
    "host->HBM, save = host->disk, load = disk->host) and outcome "
    "(ok, dedup = shared page already spilled once, fault = injected/"
    "real DMA failure, aborted = session state changed mid-transfer)",
    labels=("model", "direction", "outcome"),
)
ENGINE_KV_TIER_PREFETCH = REGISTRY.counter(
    "engine_kv_tier_prefetch_total",
    "Returning-session promotion attempts at admission (hit = pages "
    "back in HBM before the prefill slot opened — zero re-prefill, "
    "late = the transfer missed its admission deadline and the request "
    "re-prefilled, miss = no tier entry covered the prompt, expired = "
    "a staged fetch was abandoned before adoption)",
    labels=("model", "result"),
)
ENGINE_KV_TIER_BYTES = REGISTRY.counter(
    "engine_kv_tier_bytes_moved_total",
    "Bytes moved between KV tiers by direction (spill/fetch/save/load; "
    "scale planes included for int8 caches)",
    labels=("model", "direction"),
)

# --------------------------------------------------------- weight paging
ENGINE_WEIGHT_PAGES = REGISTRY.gauge(
    "engine_weight_pages_count",
    "Weight pages resident per tier (hot = on-device layer pages, "
    "warm = host-RAM layer pages; a page counts in both tiers while "
    "the retained host copy backs a promoted device tree)",
    labels=("model", "tier"),
)
ENGINE_WEIGHT_PAGE_MOVES = REGISTRY.counter(
    "engine_weight_page_moves_total",
    "Weight page tier transitions by direction (demote = HBM->host, "
    "promote = host->HBM) and outcome (ok, seed = demote served from "
    "the retained/artifact host copy with zero DMA, fault = injected/"
    "real transfer failure, aborted = new work arrived mid-demotion "
    "and the device tree was kept)",
    labels=("model", "direction", "outcome"),
)
ENGINE_WEIGHT_PREFETCH = REGISTRY.counter(
    "engine_weight_prefetch_total",
    "Warm-model promotion attempts at admission (warm = layer-streamed "
    "prefetch-ahead assembly served the wake-up, cold = the stream "
    "faulted and the blocking full-tree fallback load served it, "
    "fault = a streamed page transfer failed)",
    labels=("model", "result"),
)
ENGINE_MODEL_RESIDENCY = REGISTRY.gauge(
    "engine_model_residency_count",
    "Live engines per weight-residency state across the process (hot "
    "= weights on device, warm = weights paged to host RAM, "
    "transitioning = a demotion or promotion is in flight)",
    labels=("state",),
)

# ------------------------------------------------- disaggregated serving
ENGINE_DISAGG_REQUESTS = REGISTRY.counter(
    "engine_disagg_requests_total",
    "Requests by disaggregation path (disagg = prefilled on the "
    "prefill engine and migrated, local = stayed on the decode engine, "
    "fallback = migration failed and the request re-prefilled on the "
    "decode engine)",
    labels=("model", "path"),
)
ENGINE_KV_MIGRATED_PAGES = REGISTRY.counter(
    "engine_kv_migrated_pages_total",
    "KV pages moved through the prefill->decode migration interchange "
    "by outcome (migrated = adopted by reference on the decode engine, "
    "fault = an injected/real capture or adopt failure, dropped = "
    "captured but abandoned before adoption)",
    labels=("model", "outcome"),
)
ENGINE_KV_MIGRATION = REGISTRY.histogram(
    "engine_kv_migration_seconds",
    "Wall time of the migrate stage per disaggregated request: prefill "
    "terminal to handoff collected on the router thread (D2H gather "
    "landing + content-addressed host publish)",
    labels=("model",),
)
ENGINE_DISAGG_STAGE = REGISTRY.histogram(
    "engine_disagg_stage_seconds",
    "Per-stage wall time of disaggregated requests (queued/prefill on "
    "the prefill engine, migrate on the router, decode from resubmit "
    "to terminal on the decode engine)",
    labels=("model", "stage"),
)

# ------------------------------------------------------------ debugging
FAULTS_INJECTED = REGISTRY.counter(
    "faults_injected_total",
    "Faults actually delivered by armed LOCALAI_FAULTS injection points "
    "(utils/faultinject.py) — zero outside chaos runs",
    labels=("point",),
)
TRACE_SPANS_DROPPED = REGISTRY.counter(
    "trace_spans_dropped_total",
    "Trace entries or span events dropped by the bounded recorder "
    "(active_overflow = still-active trace evicted at active_cap, "
    "ring_evict = finished trace pushed out of the ring, note_cap = "
    "span event past the per-trace annotation cap)",
    labels=("reason",),
)
TIMELINE_RING_EVENTS = REGISTRY.gauge(
    "timeline_ring_events_count",
    "Events currently held by the flight-recorder timeline ring "
    "(telemetry/flightrec.py; exported as Chrome-trace JSON via "
    "GET /debug/timeline)",
)

# families whose help text is the port's own (see the module docstring)
REWORDED = frozenset({
    "engine_dispatch_compile_variants_count", "engine_warmup_seconds",
    "engine_device_step_seconds", "engine_device_flops_total",
    "engine_device_bytes_total", "device_hbm_used_bytes",
    "model_load_phase_seconds_total",
})
