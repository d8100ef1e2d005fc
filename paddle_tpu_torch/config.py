"""Configuration flags the port reads, with the reference's names and
defaults (``paddle_tpu/config.py``). Like there, a flag is read only
when the object that uses it is constructed.

The reference's ``flash_attention`` flag is not carried over: in the
port a CUDA tensor always takes the attention kernels, which is the
reference's ``flash_attention=True`` configuration.
"""

__all__ = ["set_flags", "get_flag"]

_flags = {
    # default per-request deadline budget of GenerationScheduler.submit;
    # 0 = no deadline
    "serving_deadline_ms": 0,
    # decode slots per session, cache-length buckets (the smallest that
    # covers max_len is chosen) and prompt paddings of the session
    # builder (models/transformer.py transformer_lm_session)
    "generation_slots": 4,
    "generation_cache_buckets": (128,),
    "generation_prompt_buckets": (16,),
}


def set_flags(**kwargs):
    for k, v in kwargs.items():
        if k not in _flags:
            raise KeyError("unknown flag %r (have %s)" % (k, sorted(_flags)))
        _flags[k] = v


def get_flag(name):
    return _flags[name]
