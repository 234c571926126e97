"""Built-in observability dashboard: a copy of
``swarmdb_tpu/api/dashboard.py``.

``GET /dashboard`` serves one self-contained HTML page (no build step, no
external assets) that polls ``/health``, ``/stats`` and
``/agents/{id}/load`` with a bearer token the operator pastes once (kept
in localStorage), and renders health and the device probe, message
counters, latency percentiles and a per-agent table. The page holds no
data itself; admin-scoped routes stay admin-scoped. The serving backend's
block of ``/health`` keeps its wire name ``tpu``.
"""

from __future__ import annotations

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>SwarmDB dashboard</title>
<style>
  body { font-family: ui-monospace, Menlo, Consolas, monospace;
         margin: 2rem; background: #111; color: #ddd; }
  h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.5rem; }
  table { border-collapse: collapse; margin-top: .5rem; }
  td, th { border: 1px solid #444; padding: .25rem .6rem; text-align: left;
           font-size: .85rem; }
  th { background: #222; }
  .ok { color: #7c7; } .bad { color: #e66; }
  #token { width: 28rem; background: #222; color: #ddd; border: 1px solid #555;
           padding: .3rem; }
  .muted { color: #888; font-size: .8rem; }
</style>
</head>
<body>
<h1>SwarmDB dashboard</h1>
<p class="muted">bearer token (admin for /stats):
  <input id="token" placeholder="paste access_token">
  <button onclick="saveToken()">use</button>
  <span id="state" class="muted"></span></p>
<h2>Health</h2><div id="health">-</div>
<h2>Engine</h2><div id="engine">-</div>
<h2>Messages</h2><div id="messages">-</div>
<h2>Latencies</h2><div id="latencies">-</div>
<h2>Agents</h2><div id="agents">-</div>
<h2>SLO sentinel</h2><div id="slo">-</div>
<p class="muted">
  <button onclick="download('/admin/slo', 'slo.json')">
    download SLO status</button>
  (baseline, windows, attributed alerts, histogram exemplars with
  trace-export links) &middot; admin token required
</p>
<h2>Tracing &amp; flight recorder</h2>
<p class="muted">
  <button onclick="download('/admin/trace/export', 'trace.json')">
    download Chrome trace</button>
  (open in <a href="https://ui.perfetto.dev" target="_blank">Perfetto</a>
  or chrome://tracing) &middot;
  <button onclick="download('/admin/cluster/trace', 'cluster_trace.json')">
    download CLUSTER trace</button>
  (one merged timeline across every cluster-map node, promotion
  instants included) &middot;
  <button onclick="download('/admin/flight', 'flight.json')">
    download flight record</button>
  (last engine steps + request timelines; auto-dumped on engine restart)
  &middot;
  <button onclick="download('/admin/pagecheck', 'pagecheck.json')">
    download pagecheck report</button>
  (page sanitizer: per-pool shadow states + violations; 503 unless
  SWARMDB_PAGECHECK=1)
  &middot;
  <button onclick="download('/admin/profile', 'profile.json')">
    download device-time profile</button>
  (per-variant device time from CUDA events / MFU / roofline, lane duty
  cycles, dispatch-shape profile; 503 if SWARMDB_PROFILE=0)
  &middot;
  <button onclick="download('/admin/mem', 'mem.json')">
    download memory report</button>
  (memory accountant: pool occupancy + residency ages, hot/warm/cold
  conversation temperature, sampled miss-ratio curve, warm-tier and
  cold-resume models; 503 if SWARMDB_MEMPROF=0)
  &middot; admin token required
</p>
<script>
function saveToken() {
  localStorage.setItem("swarmdb_token", document.getElementById("token").value);
  refresh();
}
function tok() { return localStorage.getItem("swarmdb_token") || ""; }
// ALL server-derived strings (agent ids, metric keys) are escaped before
// touching innerHTML: agent ids are client-chosen, so an unescaped cell
// would be stored XSS running in the operator's (token-holding) browser.
function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"
  }[c]));
}
function table(rows, header) {
  let h = "<table>";
  if (header) h += "<tr>" + header.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const r of rows) h += "<tr>" + r.map(c => `<td>${esc(c)}</td>`).join("") + "</tr>";
  return h + "</table>";
}
function fmt(x) {
  if (x === null || x === undefined) return "-";
  if (typeof x === "number") return Number.isInteger(x) ? x : x.toFixed(4);
  return String(x);
}
async function getJSON(path) {
  const r = await fetch(path, {headers: {"Authorization": "Bearer " + tok()}});
  if (!r.ok) throw new Error(path + " -> " + r.status);
  return await r.json();
}
async function download(path, filename) {
  const state = document.getElementById("state");
  try {
    const data = await getJSON(path);
    const blob = new Blob([JSON.stringify(data)],
                          {type: "application/json"});
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = filename;
    a.click();
    URL.revokeObjectURL(a.href);
  } catch (err) {
    state.textContent = String(err);
  }
}
async function refresh() {
  const state = document.getElementById("state");
  try {
    const health = await getJSON("/health");
    let hrows = [["status", health.status],
                 ["broker", health.broker_connected],
                 ["version", health.version]];
    if (health.tpu) {
      hrows.push(["device", fmt(health.tpu.device)],
                 ["probe_ms", fmt(health.tpu.probe_ms)]);
    }
    const hdiv = document.getElementById("health");
    hdiv.innerHTML = table(hrows);
    hdiv.className = health.status === "healthy" ? "ok" : "bad";
    if (health.tpu && health.tpu.engine) {
      const e = health.tpu.engine;
      document.getElementById("engine").innerHTML = table([
        ["active_slots", `${e.active_slots} / ${e.max_batch}`],
        ["queued", e.queued],
        ["total_requests", e.total_requests],
        ["total_generated", e.total_generated],
        ["tokens/s (60s)", fmt(e.tokens_per_sec_60s)],
      ]);
    } else {
      document.getElementById("engine").innerHTML =
        '<span class="muted">no serving backend attached</span>';
    }
    const stats = await getJSON("/stats");
    const m = stats.metrics || {};
    const counters = Object.entries(m.counters || {});
    const rates = Object.entries(m.rates || {});
    document.getElementById("messages").innerHTML =
      table([["total", stats.total_messages],
             ...Object.entries(stats.messages_by_type || {}).map(
               ([k, v]) => ["type:" + k, v]),
             ...Object.entries(stats.messages_by_status || {}).map(
               ([k, v]) => ["status:" + k, v]),
             ...rates.map(([k, v]) => ["rate:" + k + " /s", fmt(v)]),
             ...counters.map(([k, v]) => [k, v])]);
    const lat = Object.entries((m.latencies) || {});
    document.getElementById("latencies").innerHTML = lat.length
      ? table(lat.map(([k, v]) =>
          [k, fmt(v.p50), fmt(v.p95), fmt(v.p99), fmt(v.count)]),
          ["metric", "p50", "p95", "p99", "n"])
      : '<span class="muted">none yet</span>';
    // SLO sentinel (admin): its own try so a 503 (no sentinel) or 403
    // doesn't blank the rest of the page
    try {
      const slo = await getJSON("/admin/slo?tick=1");
      const rows = [["breached", slo.breached],
                    ["windows", slo.windows_total],
                    ["alerts", slo.alerts_total],
                    ["baseline", slo.baseline ? "learned" : "warming up"]];
      const last = (slo.alerts || [])[slo.alerts.length - 1];
      if (last) rows.push(
        ["last alert", `${last.id}: dominant ${last.dominant}`]);
      const w = slo.last_window || {};
      if (w.p95_ttft_s != null) rows.push(["p95 TTFT (s)", fmt(w.p95_ttft_s)]);
      if (w.cost_growth_x != null) rows.push(["cost growth x", fmt(w.cost_growth_x)]);
      const sdiv = document.getElementById("slo");
      sdiv.innerHTML = table(rows);
      sdiv.className = slo.breached ? "bad" : "ok";
    } catch (err) {
      document.getElementById("slo").innerHTML =
        '<span class="muted">' + esc(String(err)) + "</span>";
    }
    const agents = Object.entries(stats.messages_by_agent || {});
    document.getElementById("agents").innerHTML = agents.length
      ? table(agents.map(([k, v]) => [k, v.sent, v.received]),
              ["agent", "sent", "received"])
      : '<span class="muted">none</span>';
    state.textContent = "ok @ " + new Date().toLocaleTimeString();
  } catch (err) {
    state.textContent = String(err);
  }
}
document.getElementById("token").value = tok();
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
