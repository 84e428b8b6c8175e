"""Training dashboard server.

Reference parity: ``org.deeplearning4j.ui.api.UIServer`` (the play-based
DL4J training UI, ``deeplearning4j-ui-parent``): attach
a StatsStorage, browse score/throughput and per-layer parameter/update
charts while (or after) training runs.

Minimal: a stdlib ``http.server`` on a background thread serving a
self-contained HTML page (inline SVG charts, zero external assets, so it
works on a host without network access).
JSON endpoints mirror the dashboard's needs:

- ``GET /api/sessions``                     -> list of session ids
- ``GET /api/static?session=S``             -> static info record
- ``GET /api/overview?session=S``           -> score + timing series
- ``GET /api/model?session=S``              -> per-layer stats series
- ``GET /``                                 -> dashboard page

Profiler subsystem exposure (the two machine-readable seams; see
``deeplearning4j_tpu_torch.profiler``):

- ``GET /metrics``  -> Prometheus text exposition (v0.0.4) of the global
  metrics registry: compile-cache hits/misses, capture failures,
  H2D copies, train step / data-wait histograms, throughput gauges,
  serving counters. Clients that send ``Accept:
  application/openmetrics-text`` get the OpenMetrics dialect instead
  (trace-id exemplars on histogram buckets, ``# EOF`` terminator).
  Served regardless of whether a StatsStorage is attached — ``detach()``
  removes the dashboard's storage but keeps the scrape endpoint (and
  the server) alive.
- ``GET /trace``    -> Chrome Trace Event Format JSON of the global span
  tracer (open in ui.perfetto.dev or chrome://tracing).

Serving health surface (``UIServer.attach_serving(model_server)``):

- ``GET /healthz``  -> 200 while the attached model server's circuit
  breaker is closed/half-open (or no server is attached — process
  liveness), 503 when the breaker is open or the serve loop died.
- ``GET /readyz``   -> 200 only when the attached server is warmed
  (every bucket captured) and admitting; 503 while warming,
  draining, closed, or with no server attached — wire this as the load
  balancer's readiness check so a replica drains out of rotation
  before SIGTERM lands.

Storage/serving references live as *instance attributes on the HTTP
server object* (one atomic attribute read per request), not on the
handler class: re-``attach()`` used to reassign a shared class
attribute while serving threads read it — a data race two UIServer
instances could also trample.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.ui.stats import StatsStorage

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j-tpu training UI</title>
<style>
 body{font-family:system-ui,sans-serif;margin:20px;background:#fafafa}
 h1{font-size:18px} h2{font-size:14px;margin:18px 0 4px}
 .card{background:#fff;border:1px solid #ddd;border-radius:6px;
       padding:10px;margin-bottom:14px}
 svg{width:100%;height:180px} .meta{color:#666;font-size:12px}
 select{margin-bottom:10px}
 table{border-collapse:collapse;font-size:12px}
 td,th{border:1px solid #ddd;padding:3px 8px;text-align:right}
 th:first-child,td:first-child{text-align:left}
</style></head><body>
<h1>deeplearning4j-tpu training UI</h1>
<select id="sess"></select>
<div class="card"><h2>Score vs iteration</h2><svg id="score"></svg></div>
<div class="card"><h2>Update:parameter ratio (log10) vs iteration</h2>
  <svg id="ratio"></svg></div>
<div class="card"><h2>Parameter histograms (latest sampled iteration)</h2>
  <div id="hists" class="meta">enable StatsListener(with_histograms=True)
  to populate</div></div>
<div class="card"><h2>Latest layer stats</h2><div id="layers"></div></div>
<div class="card"><h2>Session</h2><div id="static" class="meta"></div></div>
<script>
function esc(s){return String(s).replace(/[&<>"']/g,
  c=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));}
function line(svg, series, names){
  const W=900,H=170,P=30; svg.innerHTML=""; svg.setAttribute("viewBox",
    "0 0 "+W+" "+H);
  let all=series.flatMap(s=>s.y).filter(v=>isFinite(v));
  if(!all.length)return;
  let xs=series[0].x, xmin=Math.min(...xs), xmax=Math.max(...xs)||1;
  let ymin=Math.min(...all), ymax=Math.max(...all);
  if(ymin===ymax){ymin-=1;ymax+=1}
  const sx=x=>P+(x-xmin)/(xmax-xmin||1)*(W-2*P);
  const sy=y=>H-P-(y-ymin)/(ymax-ymin)*(H-2*P);
  const colors=["#1f77b4","#ff7f0e","#2ca02c","#d62728","#9467bd",
                "#8c564b","#e377c2","#7f7f7f"];
  series.forEach((s,i)=>{
    let d=s.x.map((x,j)=>(j?"L":"M")+sx(x)+" "+sy(s.y[j])).join(" ");
    let p=document.createElementNS("http://www.w3.org/2000/svg","path");
    p.setAttribute("d",d); p.setAttribute("fill","none");
    p.setAttribute("stroke",colors[i%colors.length]); svg.appendChild(p);
  });
  [[ymin,H-P],[ymax,P]].forEach(([v,y])=>{
    let t=document.createElementNS("http://www.w3.org/2000/svg","text");
    t.textContent=v.toPrecision(3); t.setAttribute("x",0);
    t.setAttribute("y",y); t.setAttribute("font-size","10");
    svg.appendChild(t);});
}
async function refresh(){
  const sess=document.getElementById("sess").value; if(!sess)return;
  const ov=await (await fetch("/api/overview?session="+encodeURIComponent(sess))).json();
  line(document.getElementById("score"),
       [{x:ov.iterations,y:ov.scores}]);
  const mo=await (await fetch("/api/model?session="+encodeURIComponent(sess))).json();
  const rsvg=document.getElementById("ratio");
  const rser=Object.entries(mo.ratio_series).slice(0,8).map(([k,v])=>(
      {x:mo.iterations,y:v.map(r=>Math.log10(r+1e-12))}));
  line(rsvg,rser);
  const hj=await (await fetch("/api/histograms?session="+encodeURIComponent(sess))).json();
  const hd=document.getElementById("hists");
  const hkeys=Object.keys(hj.hists).slice(0,6);
  if(!hkeys.length){
    hd.innerHTML="enable StatsListener(with_histograms=True) to populate";
  } else {
    hd.innerHTML=hkeys.map(k=>{
      const h=hj.hists[k], W=280, H=80, n=h.counts.length;
      const m=Math.max(...h.counts)||1;
      const bars=h.counts.map((c,i)=>
        `<rect x="${i*W/n}" y="${H-c/m*H}" width="${W/n-1}" `+
        `height="${c/m*H}" fill="#1f77b4"/>`).join("");
      return `<div style="display:inline-block;margin:4px">`+
        `<div class="meta">${esc(k)} [${h.range[0].toPrecision(2)}, `+
        `${h.range[1].toPrecision(2)}]</div>`+
        `<svg viewBox="0 0 ${W} ${H}" style="width:${W}px;height:${H}px">`+
        bars+`</svg></div>`;}).join("");
  }
  let rows="<table><tr><th>layer/param</th><th>mean</th><th>std</th>"+
      "<th>norm</th><th>upd norm</th><th>upd ratio</th></tr>";
  for(const [k,v] of Object.entries(mo.latest))
    rows+=`<tr><td>${esc(k)}</td><td>${v.param_mean.toExponential(2)}</td>`+
      `<td>${v.param_std.toExponential(2)}</td>`+
      `<td>${v.param_norm.toExponential(2)}</td>`+
      `<td>${v.update_norm.toExponential(2)}</td>`+
      `<td>${v.update_ratio.toExponential(2)}</td></tr>`;
  document.getElementById("layers").innerHTML=rows+"</table>";
  const st=await (await fetch("/api/static?session="+encodeURIComponent(sess))).json();
  document.getElementById("static").textContent=JSON.stringify(st);
}
async function syncSessions(){
  const ss=await (await fetch("/api/sessions")).json();
  const sel=document.getElementById("sess");
  const cur=sel.value;
  if(ss.length !== sel.options.length){
    sel.innerHTML=ss.map(s=>`<option>${esc(s)}</option>`).join("");
    if(ss.includes(cur)) sel.value=cur;
  }
}
async function init(){
  await syncSessions();
  const sel=document.getElementById("sess");
  sel.onchange=refresh; refresh();
  setInterval(async()=>{await syncSessions(); refresh();}, 3000);
}
init();
</script></body></html>"""


def _sanitize(x):
    if isinstance(x, dict):
        return {k: _sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return None
    return x


class _Handler(BaseHTTPRequestHandler):
    @property
    def storage(self) -> Optional[StatsStorage]:
        # instance attribute on the serving HTTPServer: one atomic read,
        # swapped by attach()/detach() without touching shared class state
        return getattr(self.server, "dl4j_storage", None)

    @property
    def serving(self):
        return getattr(self.server, "dl4j_serving", None)

    def log_message(self, *a):   # silence request logging
        pass

    def _json(self, payload, code=200):
        # bare NaN/Infinity tokens are invalid JSON for browsers; map
        # non-finite floats (e.g. a NaN score) to null so the dashboard
        # keeps rendering exactly when diagnostics matter most
        self._body(json.dumps(_sanitize(payload)).encode(),
                   "application/json", code)

    def _body(self, body: bytes, ctype: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        st = self.storage
        if url.path == "/metrics":
            accept = self.headers.get("Accept", "")
            om = "application/openmetrics-text" in accept
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8" if om else
                     "text/plain; version=0.0.4; charset=utf-8")
            return self._body(
                _prof.get_registry().exposition(openmetrics=om).encode(),
                ctype)
        if url.path == "/trace":
            return self._body(
                _prof.get_tracer().export_chrome_trace().encode(),
                "application/json")
        if url.path == "/healthz":
            sv = self.serving
            if sv is None:
                return self._json({"status": "ok", "serving": "none"})
            if sv.healthy:
                return self._json({"status": "ok", "state": sv.state,
                                   "breaker": sv.breaker.state})
            return self._json({"status": "unhealthy", "state": sv.state,
                               "breaker": sv.breaker.state}, 503)
        if url.path == "/readyz":
            sv = self.serving
            if sv is None:
                return self._json({"ready": False,
                                   "reason": "no model server attached"},
                                  503)
            if sv.ready:
                return self._json({"ready": True, "state": sv.state,
                                   "queue_depth": sv.queue_depth()})
            return self._json({"ready": False, "state": sv.state}, 503)
        if url.path == "/":
            return self._body(_PAGE.encode(), "text/html")
        if st is None:
            # dashboard endpoints need a StatsStorage; /metrics, /trace
            # and the health endpoints above stay live without one
            return self._json({"error": "no stats storage attached"}, 503)
        if url.path == "/api/sessions":
            return self._json(st.listSessionIDs())
        sid = q.get("session", "")
        if url.path == "/api/static":
            return self._json(st.getStaticInfo(sid) or {})
        if url.path == "/api/overview":
            ups = st.getAllUpdates(sid)
            return self._json({
                "iterations": [u.get("iteration") for u in ups],
                "scores": [u.get("score") for u in ups],
                "times": [u.get("iteration_time_sec") for u in ups],
            })
        if url.path == "/api/model":
            ups = st.getAllUpdates(sid)
            ratio_series = {}
            for u in ups:
                for lname, rec in (u.get("layers") or {}).items():
                    ratio_series.setdefault(lname, []).append(
                        rec.get("update_ratio", 0.0))
            latest = (ups[-1].get("layers") or {}) if ups else {}
            return self._json({
                "iterations": [u.get("iteration") for u in ups],
                "ratio_series": ratio_series,
                "latest": latest,
            })
        if url.path == "/api/histograms":
            # newest update carrying per-layer histograms (StatsListener
            # with_histograms=True), ref: the reference UI's parameter /
            # update histogram tab
            ups = st.getAllUpdates(sid)
            for u in reversed(ups):
                layers = u.get("layers") or {}
                hists = {k: {"counts": v["hist_counts"],
                             "range": v["hist_range"]}
                         for k, v in layers.items() if "hist_counts" in v}
                if hists:
                    return self._json({"iteration": u.get("iteration"),
                                       "hists": hists})
            return self._json({"iteration": None, "hists": {}})
        self._json({"error": "not found"}, 404)


class UIServer:
    """ref: UIServer.getInstance().attach(statsStorage)."""

    _instance: Optional["UIServer"] = None
    # class-level twin of the instance _lifecycle lock: two threads
    # racing getInstance() must not both construct (and later bind) a
    # server for the same port
    _instance_lock = _prof.InstrumentedLock("ui:instance")

    def __init__(self, port: int = 9000):
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # serializes start/stop: attach()/attach_serving() from two
        # threads must not both observe _httpd None and double-bind the
        # port (DL4J-W213), and stop() must not race a concurrent start
        self._lifecycle = _prof.InstrumentedLock("ui:lifecycle")

    @classmethod
    def getInstance(cls, port: int = 9000) -> "UIServer":
        with UIServer._instance_lock:
            if cls._instance is None:
                cls._instance = cls(port)
            return cls._instance

    def _ensure_httpd(self) -> ThreadingHTTPServer:
        with self._lifecycle:
            if self._httpd is None:
                self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                                  _Handler)
                self.port = self._httpd.server_address[1]  # resolve port 0
                self._thread = threading.Thread(
                    target=self._httpd.serve_forever, daemon=True)
                self._thread.start()
            return self._httpd

    def attach(self, storage: StatsStorage):
        """Attach (or swap) the dashboard's StatsStorage; starts the
        HTTP server on first use. The reference lives on the server
        object, so re-attach is one atomic attribute write — no shared
        handler-class state for serving threads to race on."""
        self._ensure_httpd().dl4j_storage = storage
        return self

    def attach_serving(self, model_server):
        """Expose a :class:`~deeplearning4j_tpu_torch.serving.ModelServer`'s
        health at ``/healthz`` + ``/readyz`` (starts the HTTP server if
        needed — serving works without any StatsStorage attached)."""
        self._ensure_httpd().dl4j_serving = model_server
        return self

    def detach(self):
        """Detach the stats storage ONLY: the dashboard endpoints go
        503 but the server — and ``/metrics``, ``/trace``, the health
        endpoints — keeps running. Call :meth:`stop` to shut down."""
        if self._httpd is not None:
            self._httpd.dl4j_storage = None
        return self

    def detach_serving(self):
        if self._httpd is not None:
            self._httpd.dl4j_serving = None
        return self

    def stop(self):
        with self._lifecycle:
            if self._httpd is not None:
                self._httpd.shutdown()
                # join before closing the socket: serve_forever has
                # observed the shutdown once join returns, so no request
                # thread touches the server object past this point
                if self._thread is not None:
                    self._thread.join(timeout=10.0)
                self._httpd.server_close()
                self._httpd = None
                self._thread = None
        with UIServer._instance_lock:
            if UIServer._instance is self:
                UIServer._instance = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"
