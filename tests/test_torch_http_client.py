"""The HTTP/1.1 client of the port's handoff relay
(``xllm_service_tpu_torch/http_service/client.py``) against the port's
server (``web.py``) and a raw ``asyncio`` peer, on loopback: request
headers and body, status, content type and headers, bodies by
Content-Length and chunked, the chunks as they arrive, the total and
per-read stall timeouts, a refused connect, a body cut short, and an
abrupt close the server sees as a reset."""

import asyncio
import json

import pytest
import torch

from xllm_service_tpu_torch.common.net import pick_free_port
from xllm_service_tpu_torch.http_service import web
from xllm_service_tpu_torch.http_service.client import (
    ClientError,
    ClientSession,
    ClientTimeout,
)

torch.set_num_threads(1)   # six xdist workers share the CPU's cores


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


async def _serve(app):
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site.port


def _app(events):
    async def echo(req):
        body = await req.read()
        return web.json_response(
            {"body": body.decode(), "ctype": req.headers.get("Content-Type"),
             "x": req.headers.get("X-Thing"), "q": req.query},
            status=201, headers={"Retry-After": "3"})

    async def sse(req):
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "text/event-stream"
        await resp.prepare(req)
        try:
            for i in range(int(req.query.get("n", 3))):
                await resp.write(f"data: {i}\n\n".encode())
                await asyncio.sleep(float(req.query.get("gap", 0)))
            await resp.write_eof()
        except ConnectionResetError:
            events.append("reset")
        return resp

    async def stall(req):
        await asyncio.sleep(5)
        return web.json_response({})

    app = web.Application()
    app.router.add_post("/echo", echo)
    app.router.add_post("/sse", sse)
    app.router.add_post("/stall", stall)
    return app


def test_whole_and_chunked_bodies():
    async def main():
        runner, port = await _serve(_app([]))
        try:
            client = ClientSession()
            async with client.post(
                    f"http://127.0.0.1:{port}/echo?a=1", data=b"hello",
                    headers={"Content-Type": "application/json",
                             "X-Thing": "y"},
                    timeout=ClientTimeout(total=5)) as r:
                whole = (r.status, r.content_type, r.headers["retry-after"],
                         json.loads(await r.read()))
            async with client.post(f"http://127.0.0.1:{port}/sse?n=4",
                                   timeout=ClientTimeout(total=5)) as r:
                chunks = [c async for c in r.iter_chunks()]
                streamed = (r.status, r.content_type, chunks)
            return whole, streamed
        finally:
            await runner.cleanup()
    whole, streamed = _run(main())
    assert whole == (201, "application/json", "3", {
        "body": "hello", "ctype": "application/json", "x": "y",
        "q": {"a": "1"}})
    assert streamed == (200, "text/event-stream",
                        [f"data: {i}\n\n".encode() for i in range(4)])


@pytest.mark.parametrize("which", ["sock_read", "total"])
def test_a_silent_peer_times_out(which):
    async def main():
        runner, port = await _serve(_app([]))
        try:
            t = ClientTimeout(**{which: 0.2})
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            with pytest.raises(asyncio.TimeoutError):
                async with ClientSession().post(
                        f"http://127.0.0.1:{port}/stall", timeout=t) as r:
                    await r.read()
            return loop.time() - t0
        finally:
            await runner.cleanup()
    assert _run(main()) < 2.0


def test_stall_timeout_bounds_each_read_not_the_stream():
    """Frames 0.15 s apart under a 0.5 s stall timeout: the stream, longer
    than the timeout, completes."""
    async def main():
        runner, port = await _serve(_app([]))
        try:
            async with ClientSession().post(
                    f"http://127.0.0.1:{port}/sse?n=6&gap=0.15",
                    timeout=ClientTimeout(sock_read=0.5)) as r:
                return [c async for c in r.iter_chunks()]
        finally:
            await runner.cleanup()
    assert len(_run(main())) == 6


def test_refused_and_cut_short_are_client_errors():
    async def cut(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\nabc")
        await writer.drain()
        writer.close()

    async def main():
        port = pick_free_port()
        with pytest.raises(ClientError, match="cannot connect"):
            async with ClientSession().post(f"http://127.0.0.1:{port}/x"):
                pass
        server = await asyncio.start_server(cut, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            async with ClientSession().post(
                    f"http://127.0.0.1:{port}/x",
                    timeout=ClientTimeout(total=5)) as r:
                assert r.status == 200
                with pytest.raises(ClientError, match="cut short"):
                    await r.read()
        finally:
            server.close()
    _run(main())


def test_abrupt_close_reaches_the_server_as_a_reset():
    events = []

    async def main():
        runner, port = await _serve(_app(events))
        try:
            async with ClientSession().post(
                    f"http://127.0.0.1:{port}/sse?n=200&gap=0.01",
                    timeout=ClientTimeout(total=5)) as r:
                async for _ in r.iter_chunks():
                    r.close()
                    break
            for _ in range(200):
                if events:
                    break
                await asyncio.sleep(0.01)
        finally:
            await runner.cleanup()
    _run(main())
    assert events == ["reset"]
