"""Asyncio HTTP serving gateway over one or more Scheduler replicas.

A stdlib-only front door for the control plane: a minimal HTTP/1.1
server (``asyncio`` streams, ``Connection: close`` per request — no
web framework, no new runtime dependencies) that turns the in-process
:class:`~repro_torch.core.scheduler.Scheduler` API into a service:

* ``POST /v1/workflows`` — submit a workflow DAG as JSON (the
  :meth:`~repro_torch.core.workflow.Workflow.to_dict` document under
  ``"workflow"``, plus optional ``"at"`` / ``"deadline"`` /
  ``"klass"``).  Returns ``202`` with the chosen replica.
* ``GET /v1/workflows/{wid}/events`` — stream that workflow's typed
  :class:`~repro_torch.core.scheduler.SchedulerEvent` records as NDJSON
  (one versioned ``to_dict`` document per line), driving the clock
  lazily until the workflow reaches a terminal event.
* ``GET /v1/metrics`` — live ``serving_summary`` / ``slo_summary`` /
  ``class_summary`` counters over the merged provisional results of
  all replicas (read-only: never advances any replica's clock).
* ``POST /v1/drain`` — run every replica to quiescence, finalize, and
  return per-replica event fingerprints plus the merged summary.

Replica tier: ``replicas=N`` load-balances submissions by
least-backlog (queued arrivals + live frontier + admission backlog),
with admission-probe feedback — a replica that has been rejecting
recent arrivals is penalized so load drifts toward replicas whose
probes still admit.  With a single replica the gateway adds no
scheduling decisions of its own: a POST-then-drain run is
bit-identical (events, placements, fingerprint) to driving the same
:class:`Scheduler` directly, which ``sched_bench --gateway`` gates.

Determinism note: the gateway never steps a replica on submission.
The clock only advances while a client drains it (``/v1/drain``) or
follows an event stream, so explicit-``at`` submissions reproduce a
trace-driven run exactly.  Submissions without ``"at"`` are stamped
with wall-clock seconds since the first such arrival (see
:func:`repro_torch.workflowbench.metrics.rebase_result` for how summaries
normalize that offset away).
"""
from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import math
import threading
from typing import Callable, Optional

from repro_torch.core.scheduler import (CompletionEvent, DegradedEvent,
                                  RejectedEvent, Scheduler,
                                  SchedulerConfig, ServingResult)
from repro_torch.core.workflow import Workflow
from repro_torch.workflowbench.metrics import (class_summary, rebase_result,
                                         serving_summary, slo_summary)

__all__ = ["Gateway", "GatewayServer", "scheduler_fingerprint", "main"]


def scheduler_fingerprint(sched: Scheduler) -> str:
    """Deterministic digest of a run's observable outcome.

    SHA-256 over every retained event's versioned ``to_dict`` document
    (in emission order) plus the sorted issued-run records (stage key,
    devices, shard sizes, routed model, start, finish).  Two runs with
    equal fingerprints made the same decisions at the same times —
    the equality the single-replica gateway parity gate asserts
    against a direct :class:`Scheduler` run.
    """
    h = hashlib.sha256()
    for ev in sched.events:
        h.update(json.dumps(ev.to_dict(), sort_keys=True).encode())
    for key in sorted(sched.runs):
        r = sched.runs[key]
        doc = [list(key), list(r.placement.devices),
               list(r.placement.shard_sizes), r.placement.model,
               round(r.start, 9), round(r.finish, 9)]
        h.update(json.dumps(doc).encode())
    return h.hexdigest()


def _json_safe(obj):
    """Recursively replace NaN/inf floats with None (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _is_terminal(ev, wid: str) -> bool:
    """True when ``ev`` ends workflow ``wid``'s lifecycle."""
    if isinstance(ev, CompletionEvent):
        return ev.wid == wid and ev.workflow_done
    if isinstance(ev, RejectedEvent):
        return ev.wid == wid
    if isinstance(ev, DegradedEvent):
        return ev.kind == "gave_up" and ev.wid == wid
    return False


class _Replica:
    """One backend scheduler plus the gateway's routing bookkeeping."""

    def __init__(self, index: int, sched: Scheduler):
        self.index = index
        self.sched = sched
        self.n_submitted = 0
        # rejections already charged by the feedback penalty, so only
        # the DELTA since the last probe counts against the replica
        self.seen_rejects = 0

    def backlog(self) -> float:
        """Live load estimate: queued arrivals + frontier + admission
        backlog, plus a rejection-delta penalty (admission-probe
        feedback — a replica shedding recent load is overcommitted
        regardless of its queue length)."""
        s = self.sched
        load = (len(s._arrivals_q) + len(s._heap)
                + len(s.frontier.workflows))
        adm = s.admission
        if adm is not None:
            load += len(getattr(adm, "backlog", ()) or ())
            fresh = len(adm.rejected) - self.seen_rejects
            if fresh > 0:
                load += 4 * fresh
                self.seen_rejects = len(adm.rejected)
        return load


class Gateway:
    """N scheduler replicas behind one HTTP front door.

    ``make_scheduler`` is a zero-argument factory producing identically
    configured :class:`Scheduler` instances (one per replica); replicas
    share nothing, so per-replica runs stay independently
    deterministic.  All request handling runs on a single asyncio
    event loop — replicas are only ever touched from that loop, so no
    locking is needed.
    """

    def __init__(self, make_scheduler: Callable[[], Scheduler],
                 replicas: int = 1):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = [_Replica(i, make_scheduler())
                         for i in range(replicas)]
        self._owner: dict[str, _Replica] = {}
        self._epoch: Optional[float] = None
        self._drained = False

    @classmethod
    def from_config(cls, cluster, config: SchedulerConfig) -> "Gateway":
        """Build a gateway from a cluster and a
        :class:`SchedulerConfig` whose ``gateway`` mapping supplies
        the tier options (currently ``{"replicas": N}``)."""
        gw = dict(config.gateway or {})
        replicas = int(gw.get("replicas", 1))
        return cls(lambda: Scheduler(cluster, config), replicas)

    # -- submission ------------------------------------------------------
    def _pick_replica(self) -> _Replica:
        """Least-backlog replica (stable index order breaks ties, so a
        single replica — or an all-idle tier — routes like a direct
        scheduler run)."""
        return min(self.replicas, key=lambda r: (r.backlog(), r.index))

    def submit(self, doc: dict) -> dict:
        """Handle one ``POST /v1/workflows`` body (already parsed).

        Never steps any replica: the submission lands on the chosen
        replica's arrival queue and the clock stays put, preserving
        bit-parity with a trace-driven run.  Raises ``ValueError`` on
        a malformed document and ``RuntimeError`` after drain.
        """
        if self._drained:
            raise RuntimeError("gateway is drained; submissions closed")
        if not isinstance(doc, dict) or "workflow" not in doc:
            raise ValueError('body must be {"workflow": {...}, ...}')
        wf = Workflow.from_dict(doc["workflow"])
        at = doc.get("at")
        if at is None:
            # wall-clock arrival: seconds since the first such arrival
            import time
            if self._epoch is None:
                self._epoch = time.monotonic()
            at = time.monotonic() - self._epoch
        rep = self._pick_replica()
        wid = rep.sched.submit(
            wf, at=float(at), deadline=doc.get("deadline"),
            klass=doc.get("klass", "default"))
        rep.n_submitted += 1
        self._owner[wid] = rep
        return {"wid": wid, "replica": rep.index, "at": float(at)}

    # -- results ---------------------------------------------------------
    def merged_result(self) -> ServingResult:
        """Union of every replica's provisional
        :meth:`~repro_torch.core.scheduler.Scheduler.peek_result`, rebased
        onto the scheduler clock (wall-clock arrivals normalized in
        one place via :func:`rebase_result`)."""
        parts = [r.sched.peek_result() for r in self.replicas]
        merged = parts[0]
        if len(parts) > 1:
            import dataclasses
            stats = {}
            classes = {}
            rejected, failed = [], []
            for p in parts:
                stats.update(p.stats)
                classes.update(p.classes)
                rejected += list(p.rejected)
                failed += list(p.failed)
            merged = dataclasses.replace(
                parts[0], stats=stats, classes=classes,
                rejected=rejected, failed=failed,
                horizon=max(p.horizon for p in parts),
                max_in_flight=sum(p.max_in_flight for p in parts),
                replans=sum(p.replans for p in parts),
                model_switches=sum(p.model_switches for p in parts),
                deferrals=sum(p.deferrals for p in parts),
                preemptions=sum(p.preemptions for p in parts),
                device_downs=sum(p.device_downs for p in parts),
                shard_failures=sum(p.shard_failures for p in parts),
                retries=sum(p.retries for p in parts),
                stragglers=sum(p.stragglers for p in parts),
                speculations=sum(p.speculations for p in parts),
                shard_preemptions=sum(p.shard_preemptions
                                      for p in parts))
        return rebase_result(merged)

    def metrics(self) -> dict:
        """Handle ``GET /v1/metrics``: live counters without advancing
        any replica's clock."""
        res = self.merged_result()
        doc = {
            "replicas": [{
                "index": r.index, "now": r.sched.now,
                "submitted": r.n_submitted,
                "backlog": r.backlog(),
                "in_frontier": len(r.sched.frontier.workflows),
                "completed": len(r.sched.stats),
                "rejected": (len(r.sched.admission.rejected)
                             if r.sched.admission is not None else 0),
                "events": r.sched.events.n_total,
                "events_dropped": r.sched.events.n_dropped,
            } for r in self.replicas],
            "serving": serving_summary({"gateway": res})["gateway"],
            "slo": slo_summary({"gateway": res})["gateway"],
            "classes": class_summary(res),
        }
        return _json_safe(doc)

    def drain(self) -> dict:
        """Handle ``POST /v1/drain``: run every replica to quiescence,
        finalize (subsequent submissions get ``409``), and report
        per-replica fingerprints plus the merged summary."""
        for r in self.replicas:
            r.sched.drain()
        self._drained = True
        doc = {
            "replicas": [{
                "index": r.index,
                "fingerprint": scheduler_fingerprint(r.sched),
                "n_events": r.sched.events.n_total,
                "n_events_dropped": r.sched.events.n_dropped,
                "completed": len(r.sched.stats),
            } for r in self.replicas],
            "metrics": self.metrics(),
        }
        return _json_safe(doc)

    # -- HTTP plumbing ---------------------------------------------------
    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        """Serve one HTTP/1.1 request on an accepted connection
        (``Connection: close``; the asyncio server passes this as its
        client callback)."""
        try:
            request = await reader.readline()
            parts = request.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, target = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            n = int(headers.get("content-length", 0) or 0)
            body = await reader.readexactly(n) if n else b""
            await self._route(method, target, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as exc:  # survive bad requests, keep serving
            try:
                _respond(writer, 500, {"error": f"{type(exc).__name__}:"
                                                f" {exc}"})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method: str, target: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        target = target.split("?", 1)[0]
        if method == "POST" and target == "/v1/workflows":
            try:
                out = self.submit(json.loads(body.decode() or "null"))
            except (ValueError, KeyError, TypeError) as exc:
                _respond(writer, 400, {"error": str(exc)})
            except RuntimeError as exc:
                _respond(writer, 409, {"error": str(exc)})
            else:
                _respond(writer, 202, out)
        elif method == "GET" and target == "/v1/metrics":
            _respond(writer, 200, self.metrics())
        elif method == "POST" and target == "/v1/drain":
            _respond(writer, 200, self.drain())
        elif (method == "GET" and target.startswith("/v1/workflows/")
                and target.endswith("/events")):
            wid = target[len("/v1/workflows/"):-len("/events")]
            await self._stream_events(wid, writer)
        else:
            _respond(writer, 404, {"error": f"no route for "
                                            f"{method} {target}"})
        await writer.drain()

    async def _stream_events(self, wid: str,
                             writer: asyncio.StreamWriter) -> None:
        """NDJSON event stream for one workflow: replay the retained
        history, then lazily step the owning replica until the
        workflow's terminal event (or quiescence).  A ring-buffer
        eviction the consumer has not seen emits an ``{"error": ...}``
        line and closes — a gap must never pass silently."""
        rep = self._owner.get(wid)
        if rep is None:
            _respond(writer, 404, {"error": f"unknown workflow {wid!r}"})
            return
        sched = rep.sched
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Connection: close\r\n\r\n")
        cursor = 0
        done = False
        while True:
            if cursor < sched.events.n_dropped:
                gap = sched.events.n_dropped - cursor
                writer.write(json.dumps({
                    "error": f"event stream gap: {gap} event(s) "
                             f"evicted from the ring (event_buffer="
                             f"{sched.events.maxlen}) before this "
                             f"consumer read them"}).encode() + b"\n")
                await writer.drain()
                return
            new = sched.events.since(cursor)
            cursor = sched.events.n_total
            for ev in new:
                if getattr(ev, "wid", None) == wid or \
                        getattr(ev, "trigger_wid", None) == wid:
                    writer.write(json.dumps(ev.to_dict()).encode()
                                 + b"\n")
                    if _is_terminal(ev, wid):
                        done = True
            await writer.drain()
            if done:
                return
            if not sched.step():
                return
            await asyncio.sleep(0)  # yield so other requests interleave


def _respond(writer: asyncio.StreamWriter, status: int,
             doc: dict) -> None:
    """Write one complete JSON response (Connection: close)."""
    reason = {200: "OK", 202: "Accepted", 400: "Bad Request",
              404: "Not Found", 409: "Conflict",
              500: "Internal Server Error"}.get(status, "")
    body = json.dumps(_json_safe(doc)).encode()
    writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + body)


class GatewayServer:
    """Run a :class:`Gateway` on a background thread with its own
    asyncio event loop (benchmarks and the smoke target talk to it
    over real sockets from the calling thread).

    Usable as a context manager; :attr:`port` holds the bound port
    after :meth:`start` (pass ``port=0`` for an ephemeral one).
    """

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0):
        self.gateway = gateway
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "GatewayServer":
        """Bind and serve on a daemon thread; returns after the socket
        is listening (``port`` is then the real bound port)."""
        started = threading.Event()

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            server = loop.run_until_complete(asyncio.start_server(
                self.gateway.handle, self.host, self.port))
            self.port = server.sockets[0].getsockname()[1]
            started.set()
            try:
                loop.run_forever()
            finally:
                server.close()
                loop.run_until_complete(server.wait_closed())
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="gateway-server")
        self._thread.start()
        started.wait()
        return self

    def stop(self) -> None:
        """Stop the event loop and join the server thread."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._loop = None
        self._thread = None

    def __enter__(self) -> "GatewayServer":
        """Start on context entry."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Stop on context exit."""
        self.stop()


# ---------------------------------------------------------------------------
# CLI / smoke
# ---------------------------------------------------------------------------


def _smoke_workflow(wid: str = "smoke-0") -> Workflow:
    """Tiny three-stage chain used by ``--smoke``."""
    from repro_torch.core.workflow import Stage
    stages = {
        "plan": Stage("plan", "qwen-7b", base_cost={-1: 0.4}),
        "exec": Stage("exec", "llama-8b", base_cost={-1: 0.3},
                      parents=("plan",)),
        "judge": Stage("judge", "qwen-7b", base_cost={-1: 0.2},
                       parents=("exec",)),
    }
    return Workflow(wid, stages, num_queries=4)


def _smoke(args) -> int:
    """Boot an ephemeral gateway, push one workflow over real HTTP,
    drain the event stream, and verify nothing was dropped.  Returns
    a process exit code (nonzero on ANY dropped or missing event) —
    the ``make gateway-smoke`` gate."""
    import http.client

    from repro_torch.core.devices import heterogeneous_cluster

    cluster = heterogeneous_cluster(4)
    config = SchedulerConfig()
    gateway = Gateway(lambda: Scheduler(cluster, config),
                      replicas=args.replicas)
    with GatewayServer(gateway, host=args.host, port=args.port) as srv:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        wf = _smoke_workflow()
        conn.request("POST", "/v1/workflows",
                     body=json.dumps({"workflow": wf.to_dict(),
                                      "at": 0.0}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        sub = json.loads(resp.read())
        if resp.status != 202:
            print(f"gateway-smoke: submit failed ({resp.status}): {sub}")
            return 1
        conn.close()

        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("GET", f"/v1/workflows/{sub['wid']}/events")
        resp = conn.getresponse()
        lines = [ln for ln in resp.read().decode().splitlines() if ln]
        conn.close()
        events = [json.loads(ln) for ln in lines]
        errors = [e for e in events if "error" in e]
        done = any(e.get("type") == "CompletionEvent"
                   and e.get("workflow_done") for e in events)

        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("POST", "/v1/drain")
        drain = json.loads(conn.getresponse().read())
        conn.close()
        dropped = sum(r["n_events_dropped"] for r in drain["replicas"])

    print(f"gateway-smoke: wid={sub['wid']} replica={sub['replica']} "
          f"events={len(events)} terminal={done} "
          f"stream_errors={len(errors)} dropped={dropped}")
    if errors or dropped or not done or resp.status != 200:
        print("gateway-smoke: FAIL")
        return 1
    print("gateway-smoke: OK")
    return 0


def main(argv=None) -> int:
    """CLI entry point: ``python -m repro_torch.serving.gateway`` serves
    forever on a default heterogeneous cluster; ``--smoke`` runs the
    self-contained boot/submit/stream/drain check instead and returns
    its exit code."""
    parser = argparse.ArgumentParser(
        description="HTTP serving gateway over scheduler replicas")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--devices", type=int, default=8,
                        help="devices per replica cluster")
    parser.add_argument("--smoke", action="store_true",
                        help="boot, submit one workflow over HTTP, "
                             "drain, and exit (nonzero on any "
                             "dropped event)")
    args = parser.parse_args(argv)
    if args.smoke:
        if args.port == 8080:
            args.port = 0  # ephemeral for the smoke check
        return _smoke(args)

    from repro_torch.core.devices import heterogeneous_cluster
    cluster = heterogeneous_cluster(args.devices)
    config = SchedulerConfig()
    gateway = Gateway(lambda: Scheduler(cluster, config),
                      replicas=args.replicas)
    server = GatewayServer(gateway, host=args.host, port=args.port)
    server.start()
    print(f"gateway: serving on {server.host}:{server.port} "
          f"({args.replicas} replica(s))")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
