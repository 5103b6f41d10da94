"""Composition root + lifecycle for the orchestration service (port of
``xllm_service_tpu/master.py`` on the standard library).

Builds Scheduler → services, runs the HTTP frontend (client-facing) and
the RPC endpoint (engine-facing) as two sites of ``http_service/web.py``
in one event loop owned by a background thread. ``main()`` parses the
reference's flags, checks ports, installs signal handlers. With
``--autoscaler-enabled --autoscaler-actuator local`` and no
``--autoscaler-spawn-cmd`` the master launches the port's fake engine
(``python -m xllm_service_tpu_torch.testing.fake_engine``).

Run: ``python -m xllm_service_tpu_torch.master --coordination-addr
host:port ...`` (the coordination server:
``python -m xllm_service_tpu_torch.coordination.server``). Any number of
masters may share one coordination server: the first holds
``XLLM:SERVICE:MASTER``, the others start as active replica frontends,
and each relays the requests another owns to that owner.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import threading
from typing import Optional

from .common.config import ServiceOptions
from .coordination import CoordinationClient
from .http_service import web
from .http_service.service import XllmHttpService
from .scheduler.scheduler import Scheduler
from .utils import get_local_ip, get_logger, is_port_available

logger = get_logger(__name__)


class Master:
    def __init__(self, options: ServiceOptions,
                 coord: Optional[CoordinationClient] = None):
        self.options = options
        self.scheduler = Scheduler(options, coord=coord)
        self.service = XllmHttpService(self.scheduler)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._runners: list[web.AppRunner] = []
        self.http_port = options.http_port
        self.rpc_port = options.rpc_port

    # ---- background-thread serving (used by tests and `serve_forever`) ----
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run_loop,
                                        name="master-loop", daemon=True)
        self._thread.start()
        if not self._started.wait(15):
            raise RuntimeError("master failed to start (timed out)")
        if self._start_error is not None:
            raise RuntimeError("master failed to start") from self._start_error

    def _run_loop(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._start_sites())
        except BaseException as e:  # noqa: BLE001 — surfaced to start()
            self._start_error = e
            self._started.set()
            self._loop.run_until_complete(self._stop_sites())
            self._loop.close()
            return
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.run_until_complete(self._stop_sites())
            self._loop.close()

    async def _start_sites(self) -> None:
        http_runner = web.AppRunner(self.service.build_http_app())
        await http_runner.setup()
        http_site = web.TCPSite(http_runner, self.options.host, self.http_port)
        await http_site.start()
        self.http_port = http_site.port

        rpc_runner = web.AppRunner(self.service.build_rpc_app())
        await rpc_runner.setup()
        rpc_site = web.TCPSite(rpc_runner, self.options.host, self.rpc_port)
        await rpc_site.start()
        self.rpc_port = rpc_site.port
        self._runners = [http_runner, rpc_runner]
        # Self-address must reflect the actual RPC port (engines stream
        # Generations to it and resolve the master from coordination).
        self.scheduler.update_self_addr(
            f"{self._advertise_host()}:{self.rpc_port}")
        logger.info("master serving HTTP on :%d, RPC on :%d (master=%s)",
                    self.http_port, self.rpc_port, self.scheduler.is_master)

    def _advertise_host(self) -> str:
        if self.options.host in ("0.0.0.0", "::"):
            return ("127.0.0.1" if not self.options.coordination_addr
                    else get_local_ip())
        return self.options.host

    async def _stop_sites(self) -> None:
        for runner in self._runners:
            await runner.cleanup()

    async def _abort_sites(self) -> None:
        """SIGKILL-shaped teardown: close the listening sockets and abort
        every in-flight connection NOW — no graceful drain, no waiting on
        handlers. Peers observe an instant RST, exactly like a killed
        process."""
        for runner in self._runners:
            runner.abort()

    def stop(self) -> None:
        self.scheduler.stop()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)

    def kill(self) -> threading.Thread:
        """Abrupt death for chaos drills. Unlike :meth:`stop` (graceful:
        scheduler drains first, handlers finish), this severs every server
        socket and live connection BEFORE any cleanup, synchronously — by
        the time it returns, peers have seen the connection reset. The
        slow part (joining the loop thread, stopping scheduler threads,
        lease release) runs on the returned background thread; join it
        for test hygiene."""
        if self._loop is not None:
            fut = asyncio.run_coroutine_threadsafe(self._abort_sites(),
                                                   self._loop)
            fut.result(timeout=5)
            self._loop.call_soon_threadsafe(self._loop.stop)
        # A killed process also stops refreshing its coordination leases:
        # closing the client kills the keepalive thread and the watches,
        # so the election/membership keys lapse by TTL (they are NOT
        # released early — successors win by expiry, as under SIGKILL).
        self.scheduler._coord.close()

        def _reap() -> None:
            if self._thread is not None:
                self._thread.join(timeout=10)
            self.scheduler.stop()

        t = threading.Thread(target=_reap, name="master-reaper", daemon=True)
        t.start()
        return t


def main() -> None:
    parser = argparse.ArgumentParser(description="xllm-service-tpu master")
    ServiceOptions.add_cli_args(parser)
    args = parser.parse_args()
    options = ServiceOptions.from_cli_args(args)
    for port in (options.http_port, options.rpc_port):
        if port and not is_port_available(port, options.host):
            raise SystemExit(f"port {port} is not available")
    master = Master(options)
    master.start()
    stop_event = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop_event.set())
    stop_event.wait()
    master.stop()


if __name__ == "__main__":
    main()
