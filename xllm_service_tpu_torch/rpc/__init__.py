"""The engine's half of the service↔engine wire contract (copy of the key
scheme of ``xllm_service_tpu/rpc/__init__.py``; the dispatch, heartbeat
and telemetry wire is ``rpc/wire.py``)."""

# Coordination key layout (reference key scheme `XLLM:<TYPE>:<name>`).
INSTANCE_KEY_PREFIX = "XLLM:INSTANCE:"       # + "<TYPE>:<name>"
SERVICE_KEY_PREFIX = "XLLM:SERVICE:"         # + "<ip:rpc_port>"
MASTER_KEY = "XLLM:SERVICE:MASTER"


def instance_key(type_str: str, name: str) -> str:
    return f"{INSTANCE_KEY_PREFIX}{type_str}:{name}"


def parse_instance_key(key: str) -> tuple[str, str]:
    """-> (type, name)"""
    rest = key[len(INSTANCE_KEY_PREFIX):]
    type_str, _, name = rest.partition(":")
    return type_str, name
