"""UIServer: embedded training dashboard.

Analog of the reference's PlayUIServer (deeplearning4j-play/.../
PlayUIServer.java:53): attach a StatsStorage, serve the
train overview (score chart, throughput), per-layer mean-magnitude
charts, system info, and receive remote-routed records
(RemoteReceiverModule analog at POST /remote). Zero dependencies: a
ThreadingHTTPServer + one self-contained HTML page drawing charts on a
<canvas>.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.ui.storage import StatsStorage

# Upload cap for POST bodies (t-SNE coords / remote-routed records): the
# dashboard binds localhost, but an unbounded Content-Length read could
# still exhaust memory on a bad client.
_MAX_UPLOAD_BYTES = 8 << 20

_log = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<html><head><title>deeplearning4j_tpu_torch training UI</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
h2{margin:8px 0} .card{background:#fff;border:1px solid #ddd;
border-radius:6px;padding:12px;margin-bottom:14px}
canvas{width:100%;height:220px} td,th{padding:2px 10px;text-align:left}
nav a{margin-right:14px;text-decoration:none;color:#1668b8;
font-weight:bold} nav a.on{color:#111;border-bottom:2px solid #111}
.tab{display:none}.tab.on{display:block}
svg text{font:11px sans-serif} .node rect{fill:#eef;stroke:#88a}
img.act{image-rendering:pixelated;border:1px solid #ccc;margin:4px}
</style></head><body>
<nav id=nav>
<a href=#overview class=on>{{i18n:train.nav.overview}}</a>
<a href=#model>{{i18n:train.nav.model}}</a>
<a href=#system>{{i18n:train.nav.system}}</a>
<a href=#activations>{{i18n:train.nav.activations}}</a>
<a href=#tsne>{{i18n:train.nav.tsne}}</a>
<a href=#evaluation>{{i18n:train.nav.evaluation}}</a></nav>
<div id=overview class="tab on">
<h2>{{i18n:train.overview.title}}</h2>
<div class=card><b>{{i18n:train.overview.score}}</b><canvas id=score></canvas></div>
<div class=card><b>{{i18n:train.overview.throughput}}</b><canvas id=tput></canvas></div>
<div class=card><b>Per-layer mean |param|</b><canvas id=pm></canvas></div>
<div class=card><b>Session</b><table id=info></table></div>
</div>
<div id=model class=tab>
<h2>{{i18n:train.model.title}}</h2>
<div class=card><svg id=dag width="100%" height="500"></svg></div>
<div class=card><b>Layer detail</b> <span id=lname></span>
<table id=ldetail></table>
<b>mean |param| and mean |update| over iterations</b>
<canvas id=lseries></canvas>
<b>latest param / update / gradient histograms</b>
<canvas id=lhist style="height:140px"></canvas>
<canvas id=luhist style="height:140px"></canvas>
<canvas id=lghist style="height:140px"></canvas></div>
</div>
<div id=system class=tab>
<h2>{{i18n:train.system.title}}</h2>
<div class=card><b>Device memory (bytes in use)</b>
<canvas id=mem></canvas></div>
<div class=card><b>ETL ms / iteration</b><canvas id=etl></canvas></div>
</div>
<div id=activations class=tab>
<h2>{{i18n:train.activations.title}}</h2>
<div class=card>iteration:
<input type=range id=actslider min=0 max=0 step=1 value=0
style="width:60%">
<span id=actlabel>latest</span></div>
<div class=card id=actimgs>no activation records yet — attach a
ConvolutionalListener</div>
</div>
<div id=tsne class=tab>
<h2>t-SNE</h2>
<div class=card><canvas id=tsneplot style="height:480px"></canvas></div>
</div>
<div id=evaluation class=tab>
<h2>{{i18n:train.evaluation.title}}</h2>
<div class=card><b id=roctitle>ROC curve</b>
<canvas id=rocplot style="height:260px"></canvas></div>
<div class=card><b id=prtitle>Precision-recall curve</b>
<canvas id=prplot style="height:260px"></canvas></div>
<div class=card><b>Reliability diagram</b>
<canvas id=relplot style="height:260px"></canvas></div>
<div class=card><b id=phisttitle>Predicted probabilities</b>
<canvas id=probhist style="height:160px"></canvas></div>
</div>
<script>
function draw(cv, series, labels){
  const c = cv.getContext('2d');
  const W = cv.width = cv.clientWidth, H = cv.height = cv.clientHeight;
  c.clearRect(0,0,W,H);
  let vals = series.flat().filter(v=>isFinite(v));
  if(!vals.length) return;
  const lo = Math.min(...vals), hi = Math.max(...vals)||1;
  const colors=['#1668b8','#c2410c','#15803d','#7c3aed','#be123c',
                '#0e7490','#a16207','#4d7c0f'];
  series.forEach((s,si)=>{
    c.strokeStyle=colors[si%colors.length]; c.beginPath();
    s.forEach((v,i)=>{
      const x=i/(Math.max(s.length-1,1))*(W-40)+30;
      const y=H-15-(v-lo)/(hi-lo||1)*(H-30);
      i?c.lineTo(x,y):c.moveTo(x,y)});
    c.stroke();
    if(labels&&labels[si]){c.fillStyle=colors[si%colors.length];
      c.fillText(labels[si],35,12+12*si)}});
  c.fillStyle='#333';
  c.fillText(hi.toPrecision(4),2,12); c.fillText(lo.toPrecision(4),2,H-4);
}
function drawDag(nodes, stats){
  const svg = document.getElementById('dag');
  svg.replaceChildren();
  const pos = {}; const W = svg.clientWidth||900;
  const perRow = Math.max(2, Math.floor(W/170));
  nodes.forEach((n,i)=>{
    pos[n.name] = {x: 20+(i%perRow)*165, y: 20+Math.floor(i/perRow)*70};});
  const NS='http://www.w3.org/2000/svg';
  nodes.forEach(n=>{ (n.inputs||[]).forEach(src=>{
    if(!pos[src]) return;
    const l=document.createElementNS(NS,'line');
    l.setAttribute('x1',pos[src].x+75); l.setAttribute('y1',pos[src].y+40);
    l.setAttribute('x2',pos[n.name].x+75); l.setAttribute('y2',pos[n.name].y);
    l.setAttribute('stroke','#99a'); svg.append(l);});});
  nodes.forEach(n=>{
    const g=document.createElementNS(NS,'g'); g.setAttribute('class','node');
    const r=document.createElementNS(NS,'rect');
    r.setAttribute('x',pos[n.name].x); r.setAttribute('y',pos[n.name].y);
    r.setAttribute('width',150); r.setAttribute('height',40);
    r.setAttribute('rx',5);
    const t1=document.createElementNS(NS,'text');
    t1.setAttribute('x',pos[n.name].x+6); t1.setAttribute('y',pos[n.name].y+15);
    t1.textContent=n.name;
    const t2=document.createElementNS(NS,'text');
    t2.setAttribute('x',pos[n.name].x+6); t2.setAttribute('y',pos[n.name].y+31);
    t2.textContent=n.type+' ('+n.n_params+')';
    g.append(r,t1,t2);
    g.onclick=()=>{selectedLayer=n; drillDown(n);};
    svg.append(g);});
  svg.setAttribute('height', 20+Math.ceil(nodes.length/perRow)*70);
}
function drawBars(cv, hist, color){
  const c=cv.getContext('2d');
  const W=cv.width=cv.clientWidth, H=cv.height=cv.clientHeight;
  c.clearRect(0,0,W,H);
  if(!hist||!hist.counts||!hist.counts.length){
    c.fillText('no histogram yet',20,20); return;}
  const mx=Math.max(...hist.counts)||1, n=hist.counts.length;
  hist.counts.forEach((v,i)=>{
    c.fillStyle=color;
    const bw=(W-60)/n;
    c.fillRect(30+i*bw, H-18-(v/mx)*(H-34), bw-1, (v/mx)*(H-34));});
  c.fillStyle='#333';
  c.fillText(hist.min.toPrecision(3),30,H-4);
  c.fillText(hist.max.toPrecision(3),W-70,H-4);
}
async function drillDown(n){
  const st=latestStats[n.name]||{};
  document.getElementById('lname').textContent=n.name;
  const rows=Object.entries({name:n.name,type:n.type,
    params:n.n_params,...st}).map(([k,v])=>{
    const tr=document.createElement('tr');
    const th=document.createElement('th'); th.textContent=k;
    const td=document.createElement('td');
    td.textContent=JSON.stringify(v); tr.append(th,td); return tr;});
  document.getElementById('ldetail').replaceChildren(...rows);
  const ld=await (await fetch('api/layer?session='+dagSession
    +'&name='+encodeURIComponent(n.name))).json();
  draw(document.getElementById('lseries'),
       [ld.param_mean_magnitude||[], ld.update_mean_magnitude||[]],
       ['mean |param|','mean |update|']);
  drawBars(document.getElementById('lhist'), ld.param_histogram,
           '#1668b8');
  drawBars(document.getElementById('luhist'), ld.update_histogram,
           '#c2410c');
  drawBars(document.getElementById('lghist'), ld.grad_histogram,
           '#15803d');
}
function scatter(cv, pts, labels){
  const c=cv.getContext('2d');
  const W=cv.width=cv.clientWidth, H=cv.height=cv.clientHeight;
  c.clearRect(0,0,W,H);
  if(!pts.length) { c.fillText('POST /api/tsne or UIServer.upload_tsne()'
    ,20,20); return; }
  const xs=pts.map(p=>p[0]), ys=pts.map(p=>p[1]);
  const lx=Math.min(...xs), hx=Math.max(...xs)||1;
  const ly=Math.min(...ys), hy=Math.max(...ys)||1;
  pts.forEach((p,i)=>{
    const x=(p[0]-lx)/(hx-lx||1)*(W-60)+30;
    const y=(p[1]-ly)/(hy-ly||1)*(H-40)+20;
    c.fillStyle='#1668b8'; c.fillRect(x-1.5,y-1.5,3,3);
    if(labels&&labels[i]) c.fillText(labels[i],x+4,y+3);});
}
function xyplot(cv, curves, labels, diag){
  // x-y curves on a [0,1]x[0,1] frame (ROC / PR / reliability)
  const c=cv.getContext('2d');
  const W=cv.width=cv.clientWidth, H=cv.height=cv.clientHeight;
  c.clearRect(0,0,W,H);
  const L=35,R=10,T=10,B=20;
  const px=x=>L+x*(W-L-R), py=y=>H-B-y*(H-T-B);
  c.strokeStyle='#ccc'; c.strokeRect(L,T,W-L-R,H-T-B);
  c.fillStyle='#333';
  c.fillText('0',L-8,H-B+12); c.fillText('1',W-R-6,H-B+12);
  c.fillText('1',L-12,T+8);
  if(diag){ c.strokeStyle='#ddd'; c.beginPath();
    c.moveTo(px(0),py(0)); c.lineTo(px(1),py(1)); c.stroke(); }
  const colors=['#1668b8','#c2410c','#15803d'];
  let any=false;
  curves.forEach((cur,si)=>{
    if(!cur||!cur.x||!cur.x.length) return; any=true;
    c.strokeStyle=colors[si%colors.length]; c.beginPath();
    cur.x.forEach((x,i)=>{const X=px(x),Y=py(cur.y[i]);
      i?c.lineTo(X,Y):c.moveTo(X,Y)});
    c.stroke();
    if(labels&&labels[si]){c.fillStyle=colors[si%colors.length];
      c.fillText(labels[si],L+8,T+14+12*si)}});
  if(!any){c.fillStyle='#333';
    c.fillText('UIServer.upload_evaluation(roc=..., calibration=...)',
               L+10,H/2);}
}
function showTab(){
  const h=(location.hash||'#overview').slice(1);
  document.querySelectorAll('.tab').forEach(d=>
    d.classList.toggle('on',d.id===h));
  document.querySelectorAll('nav a').forEach(a=>
    a.classList.toggle('on',a.hash==='#'+h));
}
window.onhashchange=()=>{showTab(); tick();};
let dagSession=null, latestStats={}, lastActIter=null,
    selectedLayer=null, actIters=[], actFollow=true;
document.addEventListener('DOMContentLoaded',()=>{
  const sl=document.getElementById('actslider');
  sl.oninput=async ()=>{
    actFollow = (+sl.value === actIters.length-1);
    const it = actIters[+sl.value];
    if(it===undefined) return;
    const sessions = await (await fetch('api/sessions')).json();
    const s = sessions[sessions.length-1];
    renderActs(await (await fetch('api/activations?session='+s
      +'&iteration='+it)).json(), false);
  };
});
function renderActs(act, updateSlider){
  const imgs = act.activations_png||{};
  actIters = act.iterations||[];
  const sl=document.getElementById('actslider');
  sl.max = Math.max(0, actIters.length-1);
  if(updateSlider && actFollow) sl.value = sl.max;
  document.getElementById('actlabel').textContent =
    'iteration '+(act.iteration??'—')+' ('+actIters.length+' recorded)';
  if(!Object.keys(imgs).length) return;
  if(act.iteration===lastActIter) return;
  lastActIter = act.iteration;
  const div=document.getElementById('actimgs');
  div.replaceChildren(...Object.entries(imgs).map(([name,b64])=>{
    const w=document.createElement('div');
    const lbl=document.createElement('b'); lbl.textContent=name;
    const img=document.createElement('img'); img.className='act';
    img.src='data:image/png;base64,'+b64;
    w.append(lbl,document.createElement('br'),img); return w;}));
}
async function tick(){
  showTab();
  const h=(location.hash||'#overview').slice(1);
  const sessions = await (await fetch('api/sessions')).json();
  if(!sessions.length) return;
  const s = sessions[sessions.length-1];
  if(h==='overview'){
    const d = await (await fetch('api/overview?session='+s)).json();
    draw(document.getElementById('score'), [d.scores]);
    draw(document.getElementById('tput'), [d.samples_per_sec]);
    const names = Object.keys(d.param_mean_magnitude||{});
    draw(document.getElementById('pm'),
         names.map(n=>d.param_mean_magnitude[n]), names);
    const info = d.static_info||{};
    const tbl = document.getElementById('info');
    tbl.replaceChildren(...Object.entries(info)
      .filter(([k,v])=>k!=='model_graph').map(([k,v])=>{
      const tr=document.createElement('tr');
      const th=document.createElement('th'); th.textContent=k;
      const td=document.createElement('td');
      td.textContent=JSON.stringify(v);
      tr.append(th,td); return tr;}));
  } else if(h==='model'){
    // the graph is static per session: build the SVG once (rebuilding
    // every tick would wipe it mid-click); stats refresh via reference
    const md = await (await fetch('api/model?session='+s)).json();
    Object.assign(latestStats, md.latest_param_stats||{});
    if(dagSession!==s){ drawDag(md.graph||[], latestStats);
                        dagSession=s; }
    if(selectedLayer) drillDown(selectedLayer);
  } else if(h==='system'){
    const sys = await (await fetch('api/system?session='+s)).json();
    const d = await (await fetch('api/overview?session='+s)).json();
    draw(document.getElementById('mem'), [sys.bytes_in_use||[]]);
    draw(document.getElementById('etl'), [d.etl_ms||[]]);
  } else if(h==='activations'){
    if(actFollow){
      renderActs(await (await fetch('api/activations?session='+s))
        .json(), true);
    }
  } else if(h==='tsne'){
    const ts = await (await fetch('api/tsne')).json();
    scatter(document.getElementById('tsneplot'), ts.points||[],
            ts.labels||[]);
  } else if(h==='evaluation'){
    const ev = await (await fetch('api/evaluation')).json();
    const roc = ev.roc, pr = ev.pr, rel = ev.reliability;
    if(roc) document.getElementById('roctitle').textContent =
      'ROC curve (AUC='+(ev.auc??0).toFixed(4)+')';
    xyplot(document.getElementById('rocplot'),
           [roc?{x:roc.fpr,y:roc.tpr}:null], ['ROC'], true);
    if(pr) document.getElementById('prtitle').textContent =
      'Precision-recall curve (AUPRC='+(ev.auprc??0).toFixed(4)+')';
    xyplot(document.getElementById('prplot'),
           [pr?{x:pr.recall,y:pr.precision}:null], ['PR'], false);
    xyplot(document.getElementById('relplot'),
           [rel?{x:rel.meanPredictedValueX,y:rel.fractionPositivesY}
               :null], ['reliability'], true);
    const ph = ev.probability_histogram;
    if(ph) drawBars(document.getElementById('probhist'),
      {counts:ph.binCounts,min:ph.lower,max:ph.upper}, '#1668b8');
  }
}
tick(); setInterval(tick, 2000);
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4JTpuUI/1.0"
    storage: StatsStorage = None   # set by UIServer
    modules: list = []             # registered UIModule instances
    modules_routes: list = []      # their merged Route list
    registry = None                # metrics registry for /healthz
    #                                (None -> the process default)

    def log_message(self, *a):   # silence request logging
        pass

    def _json(self, obj, code=200, headers=None):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        u = urlparse(self.path)
        if u.path in ("/", "/train", "/train/overview"):
            from deeplearning4j_tpu_torch.ui.i18n import I18N
            q = parse_qs(u.query)
            lang = q.get("lang", [None])[0]
            body = I18N.get_instance().render(_PAGE, lang).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/metrics":
            # Prometheus text exposition of the process-wide registry
            # (observe/registry.py): training loops publish here via
            # TelemetryCollector / RecompileWatchdog
            from deeplearning4j_tpu_torch.observe import default_registry
            body = default_registry().render().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/healthz":
            # liveness + degradation: the verdict comes from the metrics
            # registry (observe/health.py) — NaN storm, recompile storm
            # or replica divergence turn the probe into a 503 with the
            # reasons spelled out, while /metrics stays a plain scrape
            from deeplearning4j_tpu_torch.observe.health import health_status
            health = health_status(self.registry)
            health["sessions"] = (len(self.storage.list_session_ids())
                                  if self.storage is not None else 0)
            self._json(health,
                       200 if health["status"] == "ok" else 503)
            return
        if u.path == "/api/i18n":
            from deeplearning4j_tpu_torch.ui.i18n import I18N
            q = parse_qs(u.query)
            lang = q.get("lang", [None])[0]
            i18n = I18N.get_instance()
            self._json({"language": i18n.resolve_language(lang),
                        "languages": i18n.languages(),
                        "messages": i18n.messages(lang)})
            return
        if u.path == "/api/sessions":
            self._json(self.storage.list_session_ids())
            return
        if u.path == "/api/overview":
            q = parse_qs(u.query)
            sess = q.get("session", [None])[0]
            if not sess:
                ids = self.storage.list_session_ids()
                sess = ids[-1] if ids else None
            self._json(self._overview(sess))
            return
        if u.path == "/api/updates":
            q = parse_qs(u.query)
            sess = q.get("session", [None])[0]
            self._json(self.storage.get_all_updates(sess) if sess else [])
            return
        if u.path == "/api/model":
            sess = self._session(u)
            static = (self.storage.get_static_info(sess) or {}) if sess \
                else {}
            latest = {}
            for up in reversed(self.storage.get_all_updates(sess)
                               if sess else []):
                if up.get("param_stats"):
                    latest = {k: {kk: vv for kk, vv in v.items()
                                  if kk != "histogram"}
                              for k, v in up["param_stats"].items()}
                    break
            self._json({"graph": static.get("model_graph", []),
                        "latest_param_stats": latest})
            return
        if u.path == "/api/system":
            sess = self._session(u)
            ups = self.storage.get_all_updates(sess) if sess else []
            self._json({
                "bytes_in_use": [
                    (up.get("memory") or {}).get("bytes_in_use") or 0
                    for up in ups if "memory" in up],
                "static_info": (self.storage.get_static_info(sess) or {})
                if sess else {},
            })
            return
        if u.path == "/api/activations":
            sess = self._session(u)
            q = parse_qs(u.query)
            want = q.get("iteration", [None])[0]
            ups = [up for up in (self.storage.get_all_updates(sess)
                                 if sess else [])
                   if up.get("type") == "activations"]
            iters = [up.get("iteration") for up in ups]
            chosen = None
            if want is not None:
                chosen = next((up for up in ups
                               if str(up.get("iteration")) == want), None)
            if chosen is None and ups:
                chosen = ups[-1]
            self._json({
                "iterations": iters,
                "iteration": chosen.get("iteration") if chosen else None,
                "activations_png": (chosen.get("activations_png", {})
                                    if chosen else {}),
            })
            return
        if u.path == "/api/layer":
            # per-layer drill-down: param/update stats over time + the
            # latest histograms (the TrainModule per-layer charts)
            sess = self._session(u)
            q = parse_qs(u.query)
            name = q.get("name", [None])[0]
            its, pmag, pstd, umag, ratio = [], [], [], [], []
            phist = uhist = ghist = None
            for up in (self.storage.get_all_updates(sess)
                       if sess else []):
                ps = (up.get("param_stats") or {}).get(name)
                if not ps:
                    continue
                its.append(up.get("iteration"))
                pmag.append(ps.get("mean_magnitude"))
                pstd.append(ps.get("stdev"))
                us = (up.get("update_stats") or {}).get(name) or {}
                um = us.get("mean_magnitude")
                umag.append(um)
                pm = ps.get("mean_magnitude")
                # um may legitimately be 0.0 (frozen layer): keep it
                ratio.append((um / pm) if um is not None and pm
                             else None)
                phist = ps.get("histogram") or phist
                uhist = us.get("histogram") or uhist
                gs = (up.get("grad_stats") or {}).get(name) or {}
                ghist = gs.get("histogram") or ghist
            self._json({
                "name": name, "iterations": its,
                "param_mean_magnitude": pmag, "param_stdev": pstd,
                "update_mean_magnitude": umag, "update_ratio": ratio,
                "param_histogram": phist, "update_histogram": uhist,
                "grad_histogram": ghist,
            })
            return
        if u.path == "/api/tsne":
            self._json(getattr(self.server, "tsne_data", None)
                       or {"points": [], "labels": []})
            return
        if u.path == "/api/evaluation":
            self._json(getattr(self.server, "evaluation_data", None)
                       or {})
            return
        route = self._match_module_route("GET", u.path)
        if route is not None:
            self._run_module_route(route, u, None)
            return
        self._json({"error": "not found"}, 404)

    def _match_module_route(self, method: str, path: str):
        """The ONE place route matching happens (404-before-body in
        do_POST and dispatch both use it)."""
        for route in self.modules_routes:
            if route.method == method and route.path == path:
                return route
        return None

    def _run_module_route(self, route, u, body) -> None:
        """Dispatch to a registered UIModule route (the UIModule.java
        SPI); built-in routes have already had their chance, so core
        paths cannot be shadowed. A ``DeadlineExceeded`` escaping the
        handler answers **504** with ``{"error": "deadline"}`` — the
        request's budget ran out, which is neither a module bug (500)
        nor an overload shed (503)."""
        from deeplearning4j_tpu_torch.parallel.deadline import DeadlineExceeded
        from deeplearning4j_tpu_torch.ui.modules import UIModuleContext
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        ctx = UIModuleContext(storage=self.storage, server=self.server,
                              headers=self.headers)
        status = 200
        extra_headers = None
        stream = None
        try:
            chaos = getattr(self.server, "chaos_request", None)
            if chaos is not None:
                chaos.fail(arg=u.path)
            out = route.handler(ctx, q, body)
            if self._is_stream(out):
                # generator/iterator payload: stream it as SSE below,
                # outside this try — once headers go out, a producer
                # error can't become a 500 JSON anyway
                stream = out
                payload = ctype = None
            elif isinstance(out, tuple) and len(out) == 3 \
                    and isinstance(out[0], dict):
                # (dict, headers_or_None, status): JSON with an
                # explicit HTTP status and optional extra headers —
                # the fleet router's 503-on-shed path (Retry-After)
                out, extra_headers, status = out
                payload, ctype = None, None
            elif isinstance(out, tuple):
                payload, ctype = out[:2]
                if len(out) == 3:
                    status = int(out[2])
                if isinstance(payload, str):
                    payload = payload.encode("utf-8")
                payload = bytes(payload)
            elif isinstance(out, dict):
                payload, ctype = None, None
            else:
                # a handler returning anything else is a module bug;
                # surface it as one instead of a 200 with JSON null
                raise TypeError(
                    "module route handler must return a dict or a "
                    f"(payload, content_type) tuple, got "
                    f"{type(out).__name__}")
        except DeadlineExceeded:
            self._json({"error": "deadline", "reason": "deadline"}, 504)
            return
        except Exception as e:                # module bug ≠ server crash
            # full detail stays in the server log; HTTP clients only
            # learn the exception class (no message text leaks)
            _log.exception("module route %s %s failed",
                           route.method, route.path)
            self._json({"error": "module route failed: "
                                 f"{type(e).__name__}"}, 500)
            return
        if stream is not None:
            self._send_event_stream(stream)
            return
        if payload is not None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        else:
            self._json(out, status, extra_headers)

    @staticmethod
    def _is_stream(out) -> bool:
        """A module route payload that should stream: any iterable that
        is not one of the fixed return forms (dict / tuple / str /
        bytes / list). Covers generators and stream objects exposing
        ``__iter__`` (e.g. GenerationStream)."""
        return (not isinstance(out, (dict, tuple, list, str, bytes))
                and (hasattr(out, "__next__") or hasattr(out, "__iter__")))

    def _send_event_stream(self, events):
        """Stream a module route's generator/iterator payload as
        Server-Sent Events. The response stays HTTP/1.0 with
        ``Connection: close`` — no Content-Length, EOF delimits the
        stream — so long-lived token streams need no chunked-framing
        change to every other route. Each yielded item becomes one
        ``data:`` event (dicts are JSON-encoded, strings pass through).

        Drain correctness: this runs inside ``_do_post``, so the
        server's active_requests counter covers the stream's whole
        lifetime — a drain() lets in-flight streams finish while the
        drain gate 503s new ones.
        """
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for ev in events:
                data = ev if isinstance(ev, str) else json.dumps(ev)
                for line in data.splitlines() or [""]:
                    self.wfile.write(b"data: " + line.encode("utf-8")
                                     + b"\n")
                self.wfile.write(b"\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream; closing the generator below
            # lets the producer cancel its sequence
            _log.info("event-stream client disconnected: %s %s",
                      self.command, self.path)
        except Exception:
            _log.exception("event-stream producer failed mid-stream")
            try:
                self.wfile.write(b"event: error\ndata: "
                                 b"{\"error\": \"stream failed\"}\n\n")
                self.wfile.flush()
            except OSError:
                pass
        finally:
            close = getattr(events, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    _log.exception("event-stream close() failed")

    def _session(self, u) -> Optional[str]:
        q = parse_qs(u.query)
        sess = q.get("session", [None])[0]
        if not sess:
            ids = self.storage.list_session_ids()
            sess = ids[-1] if ids else None
        return sess

    def _read_json_body(self):
        """Parse the POST body, enforcing the upload cap (negative
        Content-Length would make ``read(-1)`` slurp to EOF — reject it
        with the oversize case). Returns None after sending a 413."""
        n = int(self.headers.get("Content-Length", 0))
        if n < 0 or n > _MAX_UPLOAD_BYTES:
            self._json({"error": f"bad payload size ({n} bytes; "
                        f"cap {_MAX_UPLOAD_BYTES})"}, 413)
            return None
        body = self.rfile.read(n) or b"{}"
        # binary stats codec (the router's wire format) or JSON
        from deeplearning4j_tpu_torch.ui.codec import (
            decode_stats_record, is_stats_record)
        if is_stats_record(body):
            return decode_stats_record(body)
        return json.loads(body)

    def do_POST(self):
        path = urlparse(self.path).path
        if getattr(self.server, "draining", False) \
                and path in getattr(self.server, "drain_paths",
                                    ("/api/predict", "/api/generate")):
            # graceful drain: stop ADMITTING new work; requests already
            # inside _do_post — including long-lived token streams —
            # keep running to completion (tracked by active_requests,
            # which drain() waits on)
            self._json({"error": "draining"}, 503,
                       {"Retry-After": "1"})
            return
        lock = getattr(self.server, "active_lock", None)
        if lock is None:
            self._do_post(path)
            return
        with lock:
            self.server.active_requests += 1
        try:
            self._do_post(path)
        finally:
            with lock:
                self.server.active_requests -= 1

    def _do_post(self, path):
        if path == "/api/tsne":
            # TsneModule analog: upload 2-D coordinates (+labels) to plot
            try:
                payload = self._read_json_body()
                if payload is None:
                    return
                pts = payload.get("points", [])
                if not all(isinstance(p, (list, tuple)) and len(p) == 2
                           for p in pts):
                    raise ValueError("points must be [x, y] pairs")
                coords = [[float(a), float(b)] for a, b in pts]
                if not all(math.isfinite(a) and math.isfinite(b)
                           for a, b in coords):
                    raise ValueError("points must be finite numbers")
                self.server.tsne_data = {
                    "points": coords,
                    "labels": [str(l) for l in payload.get("labels", [])],
                }
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._json({"error": str(e)}, 400)
                return
            self._json({"ok": True})
            return
        if path == "/api/evaluation":
            # curve-object upload (the reference UI charts RocCurve etc.
            # produced by eval; curves arrive as their to_dict forms)
            try:
                payload = self._read_json_body()
                if payload is None:
                    return
                if not isinstance(payload, dict):
                    raise ValueError("expected a JSON object of curves")
                self.server.evaluation_data = payload
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._json({"error": str(e)}, 400)
                return
            self._json({"ok": True})
            return
        # RemoteReceiverModule analog: accept remote-routed records
        if path != "/remote":
            u = urlparse(self.path)
            # match the route BEFORE touching the body: a routing miss
            # must 404, not 400 on an unparseable probe payload
            route = self._match_module_route("POST", u.path)
            if route is None:
                self._json({"error": "not found"}, 404)
                return
            try:
                body = self._read_json_body()
            except (ValueError, json.JSONDecodeError) as e:
                self._json({"error": str(e)}, 400)
                return
            if body is None:
                return
            self._run_module_route(route, u, body)
            return
        try:
            payload = self._read_json_body()
            if payload is None:
                return
            record = payload.get("record", {})
            if "session_id" not in record:
                raise ValueError("record missing session_id")
            if payload.get("kind") == "static":
                self.storage.put_static_info(record)
            else:
                self.storage.put_update(record)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._json({"error": str(e)}, 400)
            return
        for m in self.modules:              # UIModule.reportStorageEvents
            try:
                m.on_update(record)
            except Exception:               # module bug ≠ stored-record
                pass                        # failure or server crash
        self._json({"ok": True})

    def _overview(self, session_id: Optional[str]) -> dict:
        if not session_id:
            return {}
        ups = self.storage.get_all_updates(session_id)
        pm: dict = {}
        for u in ups:
            for lname, st in (u.get("param_stats") or {}).items():
                pm.setdefault(lname, []).append(st.get("mean_magnitude"))
        return {
            "session": session_id,
            "iterations": [u.get("iteration") for u in ups],
            "scores": [u.get("score") for u in ups],
            "samples_per_sec": [u.get("samples_per_sec") or 0.0
                                for u in ups],
            "etl_ms": [u.get("etl_ms") for u in ups],
            "param_mean_magnitude": pm,
            "static_info": self.storage.get_static_info(session_id),
        }


class UIServer:
    """reference: api/UIServer.getInstance().attach(statsStorage). Serves
    on localhost; ``url`` gives the address for RemoteUIStatsStorageRouter
    peers."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, registry=None):
        self.port = port
        self.storage: Optional[StatsStorage] = None
        # registry backing /healthz degradation checks; None uses the
        # process-wide default (tests pass isolated registries)
        self.registry = registry
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._modules: List = []

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port)
        return cls._instance

    def attach(self, storage: StatsStorage):
        self.storage = storage
        if self._httpd is not None:
            self._httpd.RequestHandlerClass.storage = storage
        for m in self._modules:
            m.on_attach(storage)
        return self

    def register_module(self, module):
        """Plug a UIModule into the dashboard (reference:
        PlayUIServer's uiModules list — custom modules merge their
        routes; built-in paths cannot be shadowed)."""
        from deeplearning4j_tpu_torch.ui.modules import UIModule
        if not isinstance(module, UIModule):
            raise TypeError(f"expected a UIModule, got {type(module)}")
        self._modules.append(module)
        if self.storage is not None:
            module.on_attach(self.storage)
        if self._httpd is not None:
            h = self._httpd.RequestHandlerClass
            h.modules = list(self._modules)
            h.modules_routes = [r for m in self._modules
                                for r in m.get_routes()]
        return self

    def start(self):
        if self._httpd is not None:
            return self
        if self.storage is None:
            raise RuntimeError(
                "attach(stats_storage) before start() — the UI has "
                "nothing to serve otherwise")
        handler = type("BoundHandler", (_Handler,),
                       {"storage": self.storage,
                        "registry": self.registry,
                        "modules": list(self._modules),
                        "modules_routes": [r for m in self._modules
                                           for r in m.get_routes()]})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          handler)
        # drain bookkeeping lives on the httpd (handlers see it as
        # self.server): draining gates /api/predict admission, and
        # active_requests counts POST handlers still running so drain()
        # can wait for responses to finish SERIALIZING, not just for
        # the engine queue to empty
        self._httpd.draining = False
        self._httpd.drain_paths = {"/api/predict", "/api/generate",
                                   "/api/neighbors",
                                   "/api/neighbors/shard"}
        self._httpd.active_requests = 0
        self._httpd.active_lock = threading.Lock()
        # fault injection on the ingress edge (chaos/plan.py site
        # "ui.request"): resolved ONCE here — None when disarmed, so
        # per-request dispatch pays a single attribute probe
        from deeplearning4j_tpu_torch.chaos.hook import chaos_site
        self._httpd.chaos_request = chaos_site("ui.request")
        self.port = self._httpd.server_address[1]   # resolves port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def upload_tsne(self, points, labels=None):
        """Populate the t-SNE tab (the reference UI's TsneModule accepts
        coordinate uploads; manifold/tsne.py output plugs in directly)."""
        import numpy as np
        pts = np.asarray(points, np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"expected (N, 2) coords, got {pts.shape}")
        if self._httpd is None:
            raise RuntimeError("start() the server first")
        self._httpd.tsne_data = {
            "points": pts.tolist(),
            # `labels or []` would crash on numpy label arrays
            "labels": [] if labels is None else [str(l) for l in labels],
        }
        return self

    def upload_evaluation(self, roc=None, calibration=None):
        """Populate the Evaluation tab from a ``ROC`` and/or an
        ``EvaluationCalibration`` accumulator — their eval/curves
        exports (RocCurve, PrecisionRecallCurve, ReliabilityDiagram,
        probability Histogram) drive the charts, the analog of the
        reference UI consuming eval/curves objects."""
        if self._httpd is None:
            raise RuntimeError("start() the server first")
        data = {}
        if roc is not None:
            rc = roc.get_roc_curve()
            pr = roc.get_precision_recall_curve()
            data.update(roc=rc.to_dict(), pr=pr.to_dict(),
                        auc=rc.calculate_auc(),
                        auprc=pr.calculate_auprc())
        if calibration is not None:
            data.update(
                reliability=calibration.get_reliability_diagram()
                .to_dict(),
                probability_histogram=calibration
                .get_probability_histogram().to_dict(),
                residual_histogram=calibration
                .get_residual_histogram().to_dict(),
                ece=calibration.expected_calibration_error())
        self._httpd.evaluation_data = data
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def drain(self):
        """Stop admitting ingress requests (``drain_paths``, by default
        /api/predict and /api/generate — they get 503 + Retry-After);
        everything already in flight, including long-lived token
        streams, keeps running. Idempotent; ``active_requests`` reports
        what is left."""
        if self._httpd is not None:
            self._httpd.draining = True
        return self

    @property
    def active_requests(self) -> int:
        """POST handlers currently executing (admitted before any
        drain). 0 once every accepted request has fully responded."""
        httpd = self._httpd
        if httpd is None:
            return 0
        with httpd.active_lock:
            return httpd.active_requests

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
