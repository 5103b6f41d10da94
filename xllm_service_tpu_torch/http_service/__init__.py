"""The HTTP API and RPC endpoints of the master, on ``asyncio`` streams:
the server (``web.py``), the client the handoff relay uses
(``client.py``) and the service (``service.py``).
"""
