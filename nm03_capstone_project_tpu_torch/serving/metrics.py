"""Serving metric names and bucket layouts.

The port's copy of the JAX package's ``serving/metrics.py``: the same
series names (docs/OBSERVABILITY.md), so one dashboard reads both
packages' servers. Only the series the ported layers register are here;
the saturation, ledger, SLO, compile-cache and volume series come with
their layers. ``serving_warmup_seconds`` holds the CUDA graph capture
seconds a bucket took (the JAX package's compile + first execute).
"""

from __future__ import annotations

# -- counters ---------------------------------------------------------------
# terminal request outcomes by status: ok | error | shed | invalid | timeout
SERVING_REQUESTS_TOTAL = "serving_requests_total"
# admissions refused by backpressure (queue full or draining); also counted
# in serving_requests_total{status="shed"}
SERVING_SHED_TOTAL = "serving_shed_total"
# dispatched device batches (post-coalescing; requests/batches = mean batch)
SERVING_BATCHES_TOTAL = "serving_batches_total"
# device batches per replica lane ({lane})
SERVING_LANE_BATCHES_TOTAL = "serving_lane_batches_total"
# lane quarantine transitions ({lane, cause}); cause is deadline /
# device_lost (the supervised-dispatch outcomes) or probe_failed
SERVING_LANE_QUARANTINES_TOTAL = "serving_lane_quarantines_total"
# probation probes that passed and returned the lane to traffic ({lane})
SERVING_LANE_REINSTATED_TOTAL = "serving_lane_reinstated_total"
# chunks re-dispatched off a quarantined lane
SERVING_REQUEUES_TOTAL = "serving_requeues_total"
# batches run per lane and bucket ({lane, bucket}): CUDA graph replays on
# the card. The port's own series (the JAX package has no graphs)
SERVING_GRAPH_REPLAYS_TOTAL = "serving_graph_replays_total"
# the result tier: lookups by outcome and tier (replica store, inflight
# dedup window), fills, evictions, resident bytes
SERVING_RESULT_CACHE_HIT_TOTAL = "serving_result_cache_hit_total"
SERVING_RESULT_CACHE_MISS_TOTAL = "serving_result_cache_miss_total"
SERVING_RESULT_CACHE_FILL_TOTAL = "serving_result_cache_fill_total"
SERVING_RESULT_CACHE_EVICT_TOTAL = "serving_result_cache_evict_total"

# -- gauges -----------------------------------------------------------------
SERVING_RESULT_CACHE_BYTES = "serving_result_cache_bytes"
SERVING_INFLIGHT = "serving_inflight"  # admitted, not yet responded
SERVING_READY = "serving_ready"  # 1 = warmed + admitting, 0 otherwise
SERVING_DEGRADED = "serving_degraded"  # 1 = every lane quarantined
SERVING_LANES_READY = "serving_lanes_ready"  # warm, healthy lanes
SERVING_LANE_INFLIGHT = "serving_lane_inflight"  # {lane}: batches in flight
# per-lane fault-domain state ({lane}); values from LANE_STATE_VALUES
SERVING_LANE_STATE = "serving_lane_state"
LANE_STATE_VALUES = {"healthy": 0, "probation": 1, "quarantined": 2}
# warmup per lane and bucket: CUDA graph capture seconds (set by warmup)
SERVING_WARMUP_SECONDS = "serving_warmup_seconds"

# -- histograms -------------------------------------------------------------
SERVING_QUEUE_WAIT_SECONDS = "serving_queue_wait_seconds"
SERVING_BATCH_SIZE = "serving_batch_size"
SERVING_REQUEST_SECONDS = "serving_request_seconds"  # end-to-end, admission->response built

# Online latencies live in the millisecond-to-seconds band.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Coalesced batch sizes; bucketed at the warm batch sizes.
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

REQUEST_STATUSES = ("ok", "error", "shed", "invalid", "timeout", "probe")
