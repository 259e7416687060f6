"""Environment knobs the port reads (own copy of the entries of
localai_tfp_tpu/config/knobs.py the port serves: same names, same
defaults)."""

from __future__ import annotations

import os

_DEFAULTS = {
    # KV page-size override: power of two >= 8 dividing max_seq (0 = auto,
    # largest <= 256)
    "LOCALAI_KV_PAGE": "0",
    # physical page-count override (0 = n_slots * pages_per_slot + 1)
    "LOCALAI_KV_PAGES": "0",
    # admission queue cap: submit_many sheds beyond it with a terminal
    # "shed" event (0 = unbounded)
    "LOCALAI_MAX_QUEUE": "0",
    # cross-request prefix KV reuse (share a resident shared prefix
    # instead of re-prefilling)
    "LOCALAI_PREFIX_CACHE": "on",
    # default per-request deadline in seconds (0 = off; a request's own
    # timeout_s overrides)
    "LOCALAI_REQUEST_DEADLINE_S": "0",
    # token budget per mixed prefill/decode dispatch
    "LOCALAI_PREFILL_GROUP_TOKENS": "8192",
    # cost-model-driven scheduling: predicted device time packs
    # dispatches and drives admission/deadline decisions; off restores
    # the pure token-budget scheduler
    "LOCALAI_COST_SCHED": "on",
    # explicit inter-token-latency budget in ms: mixed/decode dispatches
    # are sized so their PREDICTED device time fits it (0 = token-budget
    # sizing only)
    "LOCALAI_ITL_BUDGET_MS": "0",
    # persist/reuse int8 quantization artifacts on disk
    "LOCALAI_QUANT_ARTIFACTS": "on",
    # quant-artifact cache root ('' = $XDG_CACHE_HOME/localai_tpu/quant)
    "LOCALAI_QUANT_CACHE_DIR": "",
    # capture every dispatch variant's CUDA graph (decode, masked decode,
    # mixed) at model load (off: each is captured at its first use)
    "LOCALAI_WARMUP": "on",
    # per-dispatch FLOPs/bytes accounting and the MFU gauge
    # (telemetry/costmodel.py)
    "LOCALAI_COSTMODEL": "on",
    # component-level device-memory ledger with memory_stats
    # reconciliation and OOM post-mortems (telemetry/hbm_ledger.py)
    "LOCALAI_HBM_LEDGER": "on",
    # per-device peak FLOP/s for MFU/roofline accounting (0 = the
    # built-in per-device table)
    "LOCALAI_PEAK_FLOPS": "0",
    # per-device peak memory bandwidth in GB/s for roofline
    # classification (0 = the built-in per-device table)
    "LOCALAI_PEAK_HBM_GBS": "0",
    # the vector store's keys and cosine scan in C++ (store/native.py;
    # off: the Python store, its large finds on the device)
    "LOCALAI_NATIVE_STORE": "on",
    # tiered KV memory: spill idle resident sessions to pinned host
    # pages, prefetch them back on return (engine/kv_tier.py)
    "LOCALAI_KV_TIER": "on",
    # host pages for spilled KV, in MiB (one pinned allocation)
    "LOCALAI_KV_TIER_HOST_MB": "256",
    # pool fill fraction above which idle residents spill in the
    # background (clamped to [0.05, 1.0])
    "LOCALAI_KV_TIER_WATERMARK": "0.85",
    # idle seconds before a resident becomes a background-spill candidate
    "LOCALAI_KV_TIER_IDLE_S": "1",
    # host-tier seconds before an entry is saved to the cold dir
    "LOCALAI_KV_TIER_COLD_S": "30",
    # how long a request whose session is cold waits for its disk load
    "LOCALAI_KV_TIER_FETCH_DEADLINE_S": "2",
    # cold-tier directory ('' disables the disk tier)
    "LOCALAI_KV_TIER_DIR": "",
    # in-flight background spill window, in MiB
    "LOCALAI_KV_TIER_INFLIGHT_MB": "64",
    # layer-granular weight paging: an idle model's weights demote to a
    # host mirror and promote back on demand (engine/weight_pager.py;
    # draft and disagg engines force it off)
    "LOCALAI_WEIGHT_PAGING": "on",
    # cross-engine budget for hot weights, in MiB: the process-wide LRU
    # demotes the least recently used model past it (0 = unlimited)
    "LOCALAI_WEIGHT_HBM_MB": "0",
    # layer pages in flight ahead of the promotion's commit cursor
    "LOCALAI_WEIGHT_PREFETCH_AHEAD": "2",
    # in-flight device-to-host window of a demotion, in MiB
    "LOCALAI_WEIGHT_INFLIGHT_MB": "256",
    # the idle watchdog demotes a model's weights instead of unloading it
    "LOCALAI_WATCHDOG_DEMOTE": "off",
    # disaggregated prefill/decode serving: a prefill engine runs long
    # prompts and migrates their KV pages to the decode engine
    # (engine/kv_migrate.py)
    "LOCALAI_DISAGG": "off",
    # prompt tokens from which a request takes the disaggregated path
    "LOCALAI_DISAGG_MIN_PROMPT": "256",
    # predicted prefill ms from which a request is disaggregated (0 =
    # prompt length alone)
    "LOCALAI_DISAGG_MIN_MS": "0",
    # budget of the migrate stage before the request re-prefills on the
    # decode engine, in seconds
    "LOCALAI_DISAGG_MIGRATE_DEADLINE_S": "5",
    # slots of the prefill engine
    "LOCALAI_DISAGG_PREFILL_SLOTS": "2",
    # flight-recorder timeline capture and its ring size (min 64)
    "LOCALAI_TIMELINE": "on",
    "LOCALAI_TIMELINE_EVENTS": "8192",
    # GET /debug/profile (torch.profiler capture) and its longest capture
    "LOCALAI_PROFILER": "off",
    "LOCALAI_PROFILER_MAX_S": "30",
    # deterministic fault-injection spec, e.g. "engine.device_step:fail@3"
    # (utils/faultinject.py)
    "LOCALAI_FAULTS": "",
}
_TRUE = ("1", "true", "yes", "on")
_FALSE = ("", "0", "false", "no", "off")


def raw(name: str) -> str:
    """The env string, or the default when unset (KeyError on a typo)."""
    return os.environ.get(name, _DEFAULTS[name])


def int_(name: str) -> int:
    try:
        return int(raw(name) or _DEFAULTS[name])
    except ValueError:
        return int(_DEFAULTS[name])


def float_(name: str) -> float:
    try:
        return float(raw(name) or _DEFAULTS[name])
    except ValueError:
        return float(_DEFAULTS[name])


def flag(name: str) -> bool:
    """On/off knob; a value that is neither reads as the default."""
    v = raw(name).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return _DEFAULTS[name] in _TRUE


def str_(name: str) -> str:
    return raw(name)
