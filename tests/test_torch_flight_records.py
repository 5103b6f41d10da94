"""``flight_records_total`` and ``native_path_active`` in ``/metrics``, the
port against the reference.

The port's flight recorder counts each bundle it captures, by kind, as the
reference's does (``common/flightrecorder.py``); the HTTP service exports
which native components serve the process. Both series render the same in
the two packages' exposition.
"""

import re

from xllm_service_tpu.common import flightrecorder as ref_fr
from xllm_service_tpu.common import metrics as ref_metrics
from xllm_service_tpu.common import native as ref_native
from xllm_service_tpu_torch.common import flightrecorder, metrics, native


def _series(text, name):
    """{label set: value} of one family in a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        m = re.match(rf"{name}(\{{[^}}]*\}})? (\S+)$", line)
        if m:
            out[m.group(1) or ""] = float(m.group(2))
    return out


def test_each_bundle_counts_as_the_references():
    pkgs = ((flightrecorder, metrics), (ref_fr, ref_metrics))
    before = [_series(m.REGISTRY.render_prometheus(), "flight_records_total")
              for _, m in pkgs]
    for fr, _ in pkgs:
        rec = fr.FlightRecorder(capacity=4)
        rec.record("failover", request_id="r-1")
        rec.record("error", request_id="r-2")
        rec.record("failover", request_id="r-3")
    after = [_series(m.REGISTRY.render_prometheus(), "flight_records_total")
             for _, m in pkgs]
    deltas = [{k: v - b.get(k, 0.0) for k, v in a.items()
               if v != b.get(k, 0.0)} for a, b in zip(after, before)]
    assert deltas[0] == deltas[1] == {'{kind="failover"}': 2.0,
                                      '{kind="error"}': 1.0}
    # The family's header renders as the reference's too.
    heads = [[ln for ln in m.REGISTRY.render_prometheus().splitlines()
              if ln.startswith("# ") and "flight_records_total" in ln]
             for _, m in pkgs]
    assert heads[0] == heads[1]


def test_native_gauges_render_as_the_references():
    native.export_gauges()
    ref_native.export_gauges()
    port = _series(metrics.REGISTRY.render_prometheus(),
                   "native_path_active")
    ref = _series(ref_metrics.REGISTRY.render_prometheus(),
                  "native_path_active")
    assert set(port) == set(ref) == {f'{{component="{c}"}}'
                                     for c in native.COMPONENTS}
    assert port == {f'{{component="{c}"}}':
                    1.0 if native.available(c) else 0.0
                    for c in native.COMPONENTS}
