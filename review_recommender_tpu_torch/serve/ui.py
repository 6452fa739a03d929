"""Built-in web UI: one static page served at GET /.

The page of `review_recommender_tpu/serve/ui.py`, with the title and the
How-it-works text describing this package: three tabs — Search (query box
+ the full parameter panel: k, rerank pool, min reviews, the five fusion
weights, gate penalty, snippet toggle; per-result score-breakdown cards;
debug line), Metrics (paste a JSONL dev set of
{"query": ..., "relevant_skus": [...]} lines -> nDCG/MRR/recall table via
POST /eval), and How-it-works. No build step, no CDN: a single HTML string
talking JSON to the same endpoints every other client uses.
"""

PAGE = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Review Search Copilot (GPU)</title>
<style>
:root { --bg:#0f1117; --card:#1a1d27; --ink:#e8e8ef; --dim:#9aa0b0;
        --acc:#7aa2ff; --ok:#6fd08c; }
* { box-sizing:border-box; }
body { margin:0; font:15px/1.5 system-ui,sans-serif; background:var(--bg);
       color:var(--ink); }
main { max-width:980px; margin:0 auto; padding:24px; }
h1 { font-size:22px; } h1 small { color:var(--dim); font-weight:400; }
nav button { background:none; border:none; color:var(--dim); font-size:15px;
  padding:8px 14px; cursor:pointer; border-bottom:2px solid transparent; }
nav button.on { color:var(--ink); border-color:var(--acc); }
.tab { display:none; } .tab.on { display:block; }
.row { display:flex; gap:10px; flex-wrap:wrap; align-items:center; }
input[type=text], textarea { width:100%; background:var(--card); border:1px
  solid #2a2e3d; color:var(--ink); border-radius:8px; padding:10px; }
textarea { min-height:120px; font-family:monospace; font-size:13px; }
button.go { background:var(--acc); color:#0b0d12; border:none; padding:10px
  22px; border-radius:8px; font-weight:600; cursor:pointer; }
.panel { background:var(--card); border-radius:10px; padding:14px 16px;
  margin:12px 0; }
.knob { display:inline-block; margin:4px 14px 4px 0; }
.knob label { color:var(--dim); font-size:12px; display:block; }
.knob input { width:90px; }
.card { background:var(--card); border-radius:10px; padding:12px 16px;
  margin:10px 0; }
.card h3 { margin:0 0 4px; font-size:15px; }
.sig { display:inline-block; margin-right:12px; font-size:12px;
  color:var(--dim); }
.sig b { color:var(--ink); }
.bar { height:4px; background:#2a2e3d; border-radius:2px; margin-top:2px; }
.bar i { display:block; height:4px; background:var(--acc); border-radius:2px; }
.debug, .took { color:var(--dim); font-size:12px; margin-top:8px; }
table { border-collapse:collapse; margin-top:10px; }
td, th { border:1px solid #2a2e3d; padding:6px 12px; font-size:13px; }
.snip { border-left:3px solid var(--ok); padding-left:10px; margin-top:6px;
  color:var(--dim); font-size:13px; }
code { background:#11131b; padding:1px 5px; border-radius:4px; }
</style></head><body><main>
<h1>Review Search Copilot <small>PyTorch / CUDA engine</small></h1>
<nav>
  <button class="on" data-t="search">Search</button>
  <button data-t="metrics">Metrics</button>
  <button data-t="how">How it works</button>
</nav>

<section class="tab on" id="tab-search">
  <div class="row" style="margin-top:12px">
    <input type="text" id="q" placeholder="e.g. yellow socks with cats"
           style="flex:1" onkeydown="if(event.key==='Enter')run()">
    <button class="go" onclick="run()">Search</button>
  </div>
  <div class="panel">
    <span class="knob"><label>top k</label><input id="k" type="number" value="10"></span>
    <span class="knob"><label>rerank pool</label><input id="rerank_k" type="number" value="0"></span>
    <span class="knob"><label>min reviews</label><input id="min_reviews" type="number" value="8"></span>
    <span class="knob"><label>w_dense</label><input id="w_dense" type="number" step="0.05" value="0.55"></span>
    <span class="knob"><label>w_bm25</label><input id="w_bm25" type="number" step="0.05" value="0.20"></span>
    <span class="knob"><label>w_rerank</label><input id="w_rerank" type="number" step="0.05" value="0.20"></span>
    <span class="knob"><label>w_prior</label><input id="w_prior" type="number" step="0.05" value="0.20"></span>
    <span class="knob"><label>w_best</label><input id="w_best" type="number" step="0.05" value="0.10"></span>
    <span class="knob"><label>gate penalty</label><input id="gate_penalty" type="number" step="0.05" value="0.5"></span>
    <span class="knob"><label>prior C</label><input id="prior_C" type="number" step="5" value="20"></span>
    <span class="knob"><label>max scan</label><input id="max_scan" type="number" value="0" title="snippet scan cap: 0 = full device scan, -1 = MAX_REVIEWS_SCAN, >0 = exact host cap"></span>
    <span class="knob"><label>snippets</label><input id="use_snips" type="checkbox"></span>
  </div>
  <div id="out"></div>
</section>

<section class="tab" id="tab-metrics">
  <p>Paste a JSONL dev set — one <code>{"query": "...", "relevant_skus":
  ["..."]}</code> per line — and evaluate the live engine.</p>
  <textarea id="devset" placeholder='{"query": "wireless headphones", "relevant_skus": ["B0..."]}'></textarea>
  <p><button class="go" onclick="evaluate()">Evaluate</button></p>
  <div id="mout"></div>
</section>

<section class="tab" id="tab-how">
  <div class="panel">
  <p><b>One device pass per query.</b> The whole corpus lives on the GPU:
  a bf16 embedding matrix, padded per-document (term&nbsp;id, tf) postings,
  rating priors and attribute-gate bitsets. A query runs dense cosine
  top-pool → BM25 → Bayesian prior + trust + gate → weighted fusion →
  top-k in one pass; concurrent requests share a batched pass, and the
  cross-encoder rerank is a batched transformer forward over the top pairs
  on a hand-written attention kernel.</p>
  <p><b>Signals.</b> <i>dense</i>: bi-encoder cosine (min-max over the
  pool) · <i>bm25</i>: Okapi BM25 (k1 1.5, b 0.75) · <i>prior</i>: Bayesian
  rating shrinkage (C=20) blended 0.7/0.3 with log review volume ·
  <i>trust</i>: 0.6·ramp(n/min_reviews) + 0.4·log-saturation ·
  <i>gate</i>: penalty^(#missed attribute groups) from color/synonym
  vocabularies · <i>best</i>: max review-snippet similarity.</p>
  </div>
</section>

<script>
document.querySelectorAll('nav button').forEach(b => b.onclick = () => {
  document.querySelectorAll('nav button').forEach(x => x.classList.remove('on'));
  document.querySelectorAll('.tab').forEach(x => x.classList.remove('on'));
  b.classList.add('on');
  document.getElementById('tab-' + b.dataset.t).classList.add('on');
});
const val = id => document.getElementById(id).value;
const num = id => parseFloat(val(id));
function params() { return {
  k:num('k'), rerank_k:num('rerank_k'), min_reviews:num('min_reviews'),
  w_dense:num('w_dense'), w_bm25:num('w_bm25'), w_rerank:num('w_rerank'),
  w_prior:num('w_prior'), w_best:num('w_best'),
  gate_penalty:num('gate_penalty'), prior_C:num('prior_C'),
  max_scan:num('max_scan'),
  use_snips:document.getElementById('use_snips').checked }; }
async function run() {
  const out = document.getElementById('out');
  out.innerHTML = '<p class="debug">searching…</p>';
  try {
    const r = await fetch('/search', {method:'POST',
      body: JSON.stringify({query: val('q'), ...params()})});
    const d = await r.json();
    if (!r.ok) { out.innerHTML = '<p class="debug">error: '+d.error+'</p>'; return; }
    const sig = (n, v) => '<span class="sig">'+n+' <b>'+v.toFixed(3)+
      '</b><span class="bar"><i style="width:'+Math.min(100, Math.max(0, v*100))+'%"></i></span></span>';
    out.innerHTML = d.results.map((x, i) => '<div class="card"><h3>'+(i+1)+
      '. '+x.sku+' <small style="color:var(--dim)">★'+x.avg_stars.toFixed(2)+
      ' · '+x.n_reviews+' reviews</small></h3>'+
      sig('final', x._final)+sig('dense', x._dense)+sig('bm25', x._bm25)+
      sig('rerank', x._rerank)+sig('prior', x._prior)+sig('trust', x._trust)+
      sig('gate', x._gate)+
      (d.snippets[x.sku] ? '<div class="snip">“'+d.snippets[x.sku].text+'”</div>' : '')+
      '<div class="debug">'+String(x.agg_text).slice(0, 220)+'…</div></div>'
    ).join('') +
    '<p class="took">'+d.took_ms.toFixed(1)+' ms · pool '+d.debug.pool+
    ' · tokens ['+d.debug.tokens.join(', ')+'] · bm25 '+d.debug.bm25_active+'</p>';
  } catch (e) { out.innerHTML = '<p class="debug">request failed: '+e+'</p>'; }
}
async function evaluate() {
  const mout = document.getElementById('mout');
  const lines = document.getElementById('devset').value.split('\\n')
    .map(s => s.trim()).filter(Boolean);
  mout.innerHTML = '<p class="debug">evaluating '+lines.length+' queries…</p>';
  try {
    const r = await fetch('/eval', {method:'POST', body: JSON.stringify(
      {queries: lines.map(JSON.parse), ...params()})});
    const d = await r.json();
    if (!r.ok) { mout.innerHTML = '<p class="debug">error: '+d.error+'</p>'; return; }
    const m = d.aggregate;
    mout.innerHTML = '<table><tr>'+Object.keys(m).map(k=>'<th>'+k+'</th>').join('')+
      '</tr><tr>'+Object.values(m).map(v=>'<td>'+(typeof v==='number'?v.toFixed(3):v)+
      '</td>').join('')+'</tr></table>';
  } catch (e) { mout.innerHTML = '<p class="debug">request failed: '+e+'</p>'; }
}
</script>
</main></body></html>
"""


def page(metrics_tab: bool = True) -> str:
    """Render the UI page. metrics_tab=False (ENABLE_METRICS_TAB) removes the
    Metrics tab button and section — the reference's feature-flagged tab
    (reference config.py:61)."""
    if metrics_tab:
        return PAGE
    html = PAGE.replace('  <button data-t="metrics">Metrics</button>\n', "")
    start = html.index('<section class="tab" id="tab-metrics">')
    end = html.index("</section>", start) + len("</section>")
    return html[:start] + html[end:]
