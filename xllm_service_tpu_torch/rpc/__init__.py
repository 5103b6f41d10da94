"""The service<->engine wire contract: the coordination key scheme (copy
of ``xllm_service_tpu/rpc/__init__.py``), the dispatch, heartbeat and
telemetry wire (``rpc/wire.py``) and the master's engine channel
(``rpc/channel.py``)."""

# Coordination key layout (reference key scheme `XLLM:<TYPE>:<name>`).
INSTANCE_KEY_PREFIX = "XLLM:INSTANCE:"       # + "<TYPE>:<name>"
SERVICE_KEY_PREFIX = "XLLM:SERVICE:"         # + "<ip:rpc_port>"
MASTER_KEY = "XLLM:SERVICE:MASTER"
CACHE_KEY_PREFIX = "XLLM:CACHE:"             # + block-hash hex (legacy)
# KV-index delta frames (rpc/wire.py encode_kv_frame): one key per master
# sync tick, zero-padded monotonic seq so lexicographic order is apply
# order; under CACHE_KEY_PREFIX so one watch covers frames and legacy keys.
CACHE_FRAME_KEY_PREFIX = CACHE_KEY_PREFIX + "FRAME:"  # + %020d seq
LOADMETRICS_KEY_PREFIX = "XLLM:LOADMETRICS:"  # + instance name
# One coalesced load/lease frame key per owning master (rpc/wire.py
# encode_load_frame), rewritten in place each sync tick.
LOADFRAME_KEY_PREFIX = "XLLM:LOADFRAME:"      # + owner rpc addr


def instance_key(type_str: str, name: str) -> str:
    return f"{INSTANCE_KEY_PREFIX}{type_str}:{name}"


def parse_instance_key(key: str) -> tuple[str, str]:
    """-> (type, name)"""
    rest = key[len(INSTANCE_KEY_PREFIX):]
    type_str, _, name = rest.partition(":")
    return type_str, name
