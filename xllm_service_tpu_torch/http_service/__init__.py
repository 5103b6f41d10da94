"""L6 HTTP API + L2 RPC endpoints (aiohttp).

Parity: reference `http_service/` + `rpc_service/` (SURVEY.md §2.2-2.3).
"""
