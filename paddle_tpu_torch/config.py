"""Configuration flags the port reads, with the reference's names and
defaults (``paddle_tpu/config.py``). Each is read when the reference
reads it: most when the object that uses it is constructed, ``amp`` at
each call that computes under it (the reference's ``Executor.run`` reads
it at each run), as each flag's comment below says.

The reference's ``flash_attention`` flag is not carried over: in the
port a CUDA tensor always takes the attention kernels, which is the
reference's ``flash_attention=True`` configuration. Nor is
``quant_pallas``, for the same reason: an int8 product on a CUDA tensor
always takes kernel B3, and the reference's dense and Pallas int8 paths
are bitwise equal by its own contract, so the flag would change nothing.
"""

__all__ = ["set_flags", "get_flag"]

_flags = {
    # default per-request deadline budget of GenerationScheduler.submit
    # and MicroBatcher.submit; 0 = no deadline
    "serving_deadline_ms": 0,
    # decode slots per session, cache-length buckets (the smallest that
    # covers max_len is chosen) and prompt paddings of the session
    # builder (models/transformer.py transformer_lm_session)
    "generation_slots": 4,
    "generation_cache_buckets": (128,),
    "generation_prompt_buckets": (16,),
    # paged KV layout: per-layer [num_blocks, block_size, d_model] pools
    # addressed through per-sequence block tables; pool_blocks 0 sizes
    # the pool to byte parity with the dense cache (slots x
    # ceil(cache_len / block_size)); prefix_cache shares prompt blocks
    # between admissions (serving/paged_cache.py)
    "generation_paged_kv": False,
    "generation_block_size": 16,
    "generation_pool_blocks": 0,
    "generation_prefix_cache": False,
    # int8 weight compute: GenerationSession quantizes the LM's mul
    # weights in place at construction (serving/quant.py) and their
    # products run int8 x int8 -> int32 through kernel B3
    # (ops/quant_ops.py); read only at session construction, and at
    # ServingEngine construction, where an int8 artifact loads with its
    # weights kept int8 (serving/quant.py install_quant_compute)
    "serving_quant_compute": False,
    # K/V cache storage dtype, dense and paged ("bfloat16" halves the
    # cache bytes; attention upcasts at the contraction); None keeps
    # float32. Read only by transformer_lm_session, and only when its
    # dtype argument is left at "float32"
    "generation_kv_dtype": None,
    # ResNet: each conv_bn_layer is one conv2d_bn op whose batch
    # statistics come from the convolution's own pass (ops/conv_bn.py;
    # kernel B1 for the 1x1 stride-1 f32 convolutions on the card) in
    # place of conv2d + batch_norm; read when the model is built
    # (models/resnet.py)
    "fused_conv_bn": False,
    # decode policy (serving/decoding): read only at session build, by
    # DecodePolicy.from_flags; the all-defaults combination resolves to
    # no policy object at all, so greedy sessions stay as they were
    "decode_policy": "greedy",
    "decode_temperature": 1.0,
    "decode_top_k": 0,
    "decode_top_p": 1.0,
    "decode_speculate_k": 0,
    "decode_draft_model": None,
    "decode_constraint": None,
    # mixed precision: None, or the dtype name ("bfloat16") that the
    # WHITE ops' float32 inputs are cast to (amp.py); read at each forward
    # and loss of a model (models/transformer.py, models/resnet.py), at
    # each Executor.run, and at each session build and generation call,
    # which refuse it
    "amp": None,
    # the executor (core/executor.py), read at each run: check_nan_inf
    # raises FloatingPointError naming every op whose output is not
    # finite; nonfinite_guard leaves the state unchanged when a fetched
    # float is not finite (the RNG key still advances)
    "check_nan_inf": False,
    "nonfinite_guard": False,
    # the staged input pipeline (reader/staging.py): pack every batch's
    # feed arrays into ONE 64-byte-aligned block of the pinned staging
    # arena and issue ONE host-to-device copy per batch; the executor
    # unpacks it on the card (slices viewed as each slot's dtype,
    # core/ingest.py) and drops the consumed buffer. Off (default): one
    # copy per array. Independent of wire_dtype declarations
    # (layers.data), which are opt-in per feed. Read by StagedReader at
    # each batch it stages
    "packed_feeds": False,
    # metric hooks and host spans (observability/tracing.py: synced into
    # the tracer by the observability package's change hook); read by the
    # executor at each run: a cache entry of a forward program is
    # exported at its second run (Executor.lower) to count its
    # operations and bytes
    "telemetry": False,
    # the persistent compile cache (core/compile_cache.py), read by the
    # executor at each run. None (default): no filesystem access at all.
    # A directory: each forward program's cache entry is stored there as
    # its torch.export program, keyed by a stable digest of the program
    # content + feed/fetch signature + trace-time flags + the torch,
    # device and kernel-source fingerprint, and a fresh process loads it
    # instead of rebuilding it. Entries are sha256-manifested; a corrupt
    # or truncated entry is quarantined to corrupt_* and rebuilt (a
    # poisoned dir can slow a start, never crash or mis-execute one).
    # Training programs (vjp_grad ops) store nothing. Trust boundary:
    # entries load through torch.export.load
    "compile_cache_dir": None,
    # 0 (default): the compile cache dir grows without bound. Else
    # store() evicts the coldest-mtime entries (bin + manifest together;
    # load() hits touch mtime, so this is LRU) until the dir fits, never
    # the entry it just published. Only read on the store path
    "compile_cache_max_bytes": 0,
    # ServingEngine batch buckets (serving/engine.py): every batch is
    # zero-padded up to the smallest bucket that holds it; read when an
    # engine is constructed without buckets
    "serving_buckets": (1, 8, 32),
    # serving breakers (serving/resilience.py ReplicaBreaker): read only
    # when a GenerationScheduler or a ServingEngine is constructed; 0
    # failures = no breakers
    "serving_breaker_failures": 0,
    "serving_breaker_cooldown_ms": 1000.0,
    # the fault-injection master switch (resilience/faults.py): hook
    # sites are one flag check while it is off; arm()/disarm() flip it
    "fault_injection": False,
    # stateful-generation resilience (serving/generation.py): token
    # replay, session rebuild and the step timeout, read only at
    # scheduler construction; the defaults keep the dispatcher's hot path
    # and failure behaviour as they were
    "generation_replay_attempts": 0,
    "generation_rebuild_limit": 0,
    "generation_step_timeout_ms": 0,
    # request-scoped tracing, the flight recorder and live introspection
    # (observability/request_trace.py, flight.py): synced into module
    # state by the observability package's change hook, never read per
    # request; a nonzero telemetry_port raises, as its HTTP server is not
    # ported yet
    # sharded embedding tables (embeddings/sharded.py), read only for a
    # program that registered a distributed table (the executor gates on
    # the program's table registry, one getattr; a plain program reads
    # none of them), at each run, and keyed into the executor's cache:
    # embedding_shard_rows row-shards each table created by
    # layers.embedding(..., is_distributed=True) over the strategy's data
    # axis by row_id % num_shards (the mod-interleaved layout), its
    # optimizer slots alongside, so no rank holds a whole table; False
    # (default): distributed tables stay replicated and the lookup is a
    # plain gather. embedding_a2a (with sharding on) runs the lookup and
    # its gradient as the two-hop all_to_all (ids to their owners, rows
    # back; gradients reverse the route and are merged per shard); False
    # (default): every rank gathers the table's blocks and takes its
    # rows, and the gradients' rows go to every rank. Same numbers either
    # way. embedding_wire_dtype: the payload dtype of the a2a ROW hop;
    # "int8" quantizes rows on their shard (symmetric per-row amax/127
    # scale), the int8 rows and one f32 scale a row cross the wire and
    # the receiver dequantizes (the gradient hop stays f32); None
    # (default): f32 rows
    "embedding_shard_rows": False,
    "embedding_a2a": False,
    "embedding_wire_dtype": None,
    "request_tracing": False,
    "trace_sample_rate": 1.0,
    "telemetry_port": 0,
    "flight_dir": None,
}

# Observers called with the flag dict after every set_flags (the
# observability package arms and disarms its tracers through this).
_on_change = []


def set_flags(**kwargs):
    for k, v in kwargs.items():
        if k not in _flags:
            raise KeyError("unknown flag %r (have %s)" % (k, sorted(_flags)))
        _flags[k] = v
    for cb in list(_on_change):
        cb(_flags)


def get_flag(name):
    return _flags[name]
