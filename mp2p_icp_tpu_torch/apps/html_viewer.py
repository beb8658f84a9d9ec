"""Self-contained interactive HTML/WebGL exports for the viewer apps.

Port of ``mp2p_icp_tpu/apps/html_viewer.py``, with its own copy of the page
(``_HTML``, ``_JS``, ``_PALETTE``): the same map or log gives the same file,
byte for byte. The reference's apps/mm-viewer and apps/icp-log-viewer are
interactive nanogui/OpenGL inspectors (orbit camera, layer toggles,
point-size/colour controls, iteration slider with pairing lines); the
equivalent here is ONE standalone .html file: embedded base64 Float32
buffers and a dependency-free WebGL1 point renderer with orbit/pan/zoom,
per-layer visibility toggles, colour modes (height / intensity / layer),
voxel-layer occupancy rendering, an optional trajectory polyline, and (for
.icplog records) the iteration slider with decimated pairing lines. Open
in any browser; it needs no network access (everything is inlined).
Tensors are read on the host (``.cpu()``) from whatever device holds them.
"""

from __future__ import annotations

import base64
import html
import json

import numpy as np

from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.io.mm import to_numpy

_PALETTE = [
    (0.36, 0.68, 0.89), (0.95, 0.59, 0.22), (0.52, 0.80, 0.40),
    (0.85, 0.40, 0.45), (0.65, 0.55, 0.85), (0.55, 0.45, 0.35),
    (0.90, 0.75, 0.30), (0.45, 0.80, 0.78),
]


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, np.float32).tobytes()
    ).decode("ascii")


def _decimate(pts: np.ndarray, extra, max_points: int):
    if pts.shape[0] <= max_points:
        return pts, extra
    stride = -(-pts.shape[0] // max_points)
    return pts[::stride], (None if extra is None else extra[::stride])


def _collect_layers(mm, max_points_per_layer: int):
    """-> list of layer dicts (name, kind, b64 xyz, optional b64 scalar)."""
    layers = mm.layers if hasattr(mm, "layers") else mm
    out = []
    for name, layer in layers.items():
        if isinstance(layer, PointCloud):
            pts = layer.to_numpy()
            if pts.shape[0] == 0:
                continue
            inten = (
                to_numpy(layer.intensity[: pts.shape[0]]).astype(np.float32)
                if layer.intensity is not None
                else None
            )
            pts, inten = _decimate(pts, inten, max_points_per_layer)
            out.append({
                "name": name, "kind": "points", "n": int(pts.shape[0]),
                "xyz": _b64(pts),
                "scalar": None if inten is None else _b64(inten),
            })
        elif isinstance(layer, VoxelGridLayer):
            valid = to_numpy(layer.valid)
            centers = to_numpy(layer.centers())[valid]
            occ = to_numpy(layer.occupancy)[valid]
            centers, occ = _decimate(centers, occ, max_points_per_layer)
            if centers.shape[0] == 0:
                continue
            out.append({
                "name": name, "kind": "voxels", "n": int(centers.shape[0]),
                "xyz": _b64(centers), "scalar": _b64(occ),
                "size": float(layer.resolution),
            })
    return out


_JS = r"""
'use strict';
function decode(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
const canvas=document.getElementById('gl');
const gl=canvas.getContext('webgl');
const VS=`attribute vec3 p;attribute float s;uniform mat4 mvp;uniform float psize;
varying float vs;void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=psize;vs=s;}`;
const FS=`precision mediump float;uniform vec3 base;uniform int mode;varying float vs;
vec3 turbo(float t){t=clamp(t,0.0,1.0);
 return clamp(vec3(0.14+4.5*t-5.2*t*t+1.8*t*t*t,
                   0.09+2.3*t+1.6*t*t-3.1*t*t*t,
                   0.27+4.8*t-14.0*t*t+9.2*t*t*t),0.0,1.0);}
void main(){vec3 c=base;if(mode==1)c=turbo(vs);gl_FragColor=vec4(c,1.0);}`;
const LVS=`attribute vec3 p;uniform mat4 mvp;void main(){gl_Position=mvp*vec4(p,1.0);}`;
const LFS=`precision mediump float;uniform vec3 col;void main(){gl_FragColor=vec4(col,0.9);}`;
function prog(vs,fs){function sh(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);return s;}const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));
 gl.linkProgram(p);return p;}
const P=prog(VS,FS), PL=prog(LVS,LFS);
// --- matrices
function mmul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(f,asp,n,fa){const t=1/Math.tan(f/2);const o=new Float32Array(16);
 o[0]=t/asp;o[5]=t;o[10]=(fa+n)/(n-fa);o[11]=-1;o[14]=2*fa*n/(n-fa);return o;}
// --- scene state
let center=[0,0,0],radius=10;
let az=0.8,el=0.5,dist=0,panX=0,panY=0,psize=2.0;
function viewMat(){
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const eye=[center[0]+dist*ce*ca,center[1]+dist*ce*sa,center[2]+dist*se];
 const f=norm3(sub3(center,eye));const up=[0,0,1];
 const r=norm3(cross(f,up));const u=cross(r,f);
 const m=new Float32Array(16);
 m[0]=r[0];m[4]=r[1];m[8]=r[2];
 m[1]=u[0];m[5]=u[1];m[9]=u[2];
 m[2]=-f[0];m[6]=-f[1];m[10]=-f[2];m[15]=1;
 const e2=[eye[0]-panX*r[0]-panY*u[0],eye[1]-panX*r[1]-panY*u[1],eye[2]-panX*r[2]-panY*u[2]];
 m[12]=-(r[0]*e2[0]+r[1]*e2[1]+r[2]*e2[2]);
 m[13]=-(u[0]*e2[0]+u[1]*e2[1]+u[2]*e2[2]);
 m[14]=f[0]*e2[0]+f[1]*e2[1]+f[2]*e2[2];
 return m;}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const n=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/n,a[1]/n,a[2]/n];}
// --- upload layers
const buffers=[];
let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
DATA.layers.forEach((L,li)=>{
 const xyz=decode(L.xyz);const n=L.n;
 for(let i=0;i<n;i++)for(let a=0;a<3;a++){
  const v=xyz[3*i+a];if(v<lo[a])lo[a]=v;if(v>hi[a])hi[a]=v;}
 const scalar=L.scalar?decode(L.scalar):null;
 // height fallback scalar
 let s=scalar;if(!s){s=new Float32Array(n);for(let i=0;i<n;i++)s[i]=xyz[3*i+2];}
 // normalize scalar to [0,1]
 let mn=1e9,mx=-1e9;for(let i=0;i<n;i++){if(s[i]<mn)mn=s[i];if(s[i]>mx)mx=s[i];}
 const sn=new Float32Array(n);const span=(mx-mn)||1;
 for(let i=0;i<n;i++)sn[i]=(s[i]-mn)/span;
 const bp=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bp);
 gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.STATIC_DRAW);
 const bs=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bs);
 gl.bufferData(gl.ARRAY_BUFFER,sn,gl.STATIC_DRAW);
 buffers.push({bp:bp,bs:bs,n:n,visible:true,layer:L,idx:li});
});
center=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
radius=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1)*0.7;
dist=radius*2.2;
// trajectory + pairing line buffers
let trajBuf=null,trajN=0;
if(DATA.traj){const t=decode(DATA.traj);trajN=t.length/3;
 trajBuf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
 gl.bufferData(gl.ARRAY_BUFFER,t,gl.STATIC_DRAW);}
let pairBuf=gl.createBuffer(),pairN=0;
// per-iteration local pose (icplog mode)
let iterPoses=null,iter=-1;
if(DATA.iters){iterPoses=DATA.iters;iter=iterPoses.length-1;}
function localMat(){
 if(!iterPoses||iter<0)return null;
 const P=iterPoses[iter]; // [R(9) row-major, t(3)]
 const m=new Float32Array(16);
 m[0]=P[0];m[4]=P[1];m[8]=P[2];m[12]=P[9];
 m[1]=P[3];m[5]=P[4];m[9]=P[5];m[13]=P[10];
 m[2]=P[6];m[6]=P[7];m[10]=P[8];m[14]=P[11];
 m[15]=1;return m;}
function updatePairs(){
 pairN=0;
 if(!DATA.pairs||iter<0)return;
 const pr=DATA.pairs[iter];if(!pr)return;
 const loc=decode(pr.l),glo=decode(pr.g);
 const P=iterPoses[iter];
 const n=loc.length/3;const v=new Float32Array(n*6);
 for(let i=0;i<n;i++){
  const x=loc[3*i],y=loc[3*i+1],z=loc[3*i+2];
  v[6*i]  =P[0]*x+P[1]*y+P[2]*z+P[9];
  v[6*i+1]=P[3]*x+P[4]*y+P[5]*z+P[10];
  v[6*i+2]=P[6]*x+P[7]*y+P[8]*z+P[11];
  v[6*i+3]=glo[3*i];v[6*i+4]=glo[3*i+1];v[6*i+5]=glo[3*i+2];}
 gl.bindBuffer(gl.ARRAY_BUFFER,pairBuf);
 gl.bufferData(gl.ARRAY_BUFFER,v,gl.STATIC_DRAW);pairN=n*2;}
updatePairs();
// --- render
let colorMode=1;
function draw(){
 const w=canvas.clientWidth,h=canvas.clientHeight;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.07,0.08,0.10,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const mvp=mmul(persp(0.9,w/h,radius*0.01,radius*40),viewMat());
 gl.useProgram(P);
 const uMvp=gl.getUniformLocation(P,'mvp');
 const lm=localMat();
 buffers.forEach(B=>{
  if(!B.visible)return;
  let m=mvp;
  if(lm&&B.layer.local)m=mmul(mvp,lm);
  gl.uniformMatrix4fv(uMvp,false,m);
  gl.uniform1f(gl.getUniformLocation(P,'psize'),
   B.layer.kind==='voxels'?psize*1.8:psize);
  const pal=PALETTE[B.idx%PALETTE.length];
  gl.uniform3f(gl.getUniformLocation(P,'base'),pal[0],pal[1],pal[2]);
  gl.uniform1i(gl.getUniformLocation(P,'mode'),colorMode);
  const ap=gl.getAttribLocation(P,'p');
  gl.bindBuffer(gl.ARRAY_BUFFER,B.bp);
  gl.enableVertexAttribArray(ap);gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
  const as=gl.getAttribLocation(P,'s');
  gl.bindBuffer(gl.ARRAY_BUFFER,B.bs);
  gl.enableVertexAttribArray(as);gl.vertexAttribPointer(as,1,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,B.n);
 });
 gl.useProgram(PL);
 gl.uniformMatrix4fv(gl.getUniformLocation(PL,'mvp'),false,mvp);
 if(trajBuf&&trajN>1){
  gl.uniform3f(gl.getUniformLocation(PL,'col'),1.0,0.3,0.3);
  const ap=gl.getAttribLocation(PL,'p');
  gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
  gl.enableVertexAttribArray(ap);gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINE_STRIP,0,trajN);}
 if(pairN>0){
  gl.uniform3f(gl.getUniformLocation(PL,'col'),0.95,0.85,0.2);
  const ap=gl.getAttribLocation(PL,'p');
  gl.bindBuffer(gl.ARRAY_BUFFER,pairBuf);
  gl.enableVertexAttribArray(ap);gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINES,0,pairN);}
 requestAnimationFrame(draw);}
requestAnimationFrame(draw);
// --- controls
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,btn:e.button};});
window.addEventListener('mouseup',()=>{drag=null;});
window.addEventListener('mousemove',e=>{
 if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.btn===0){az-=dx*0.008;el=Math.min(1.5,Math.max(-1.5,el+dy*0.008));}
 else{panX+=dx*dist*0.0015;panY-=dy*dist*0.0015;}});
canvas.addEventListener('contextmenu',e=>e.preventDefault());
canvas.addEventListener('wheel',e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);},{passive:false});
// --- UI
const ui=document.getElementById('layers');
buffers.forEach(B=>{
 const lab=document.createElement('label');
 const cb=document.createElement('input');cb.type='checkbox';cb.checked=true;
 cb.onchange=()=>{B.visible=cb.checked;};
 lab.appendChild(cb);
 lab.appendChild(document.createTextNode(
  ` ${B.layer.name} (${B.n}${B.layer.kind==='voxels'?' voxels':' pts'})`));
 ui.appendChild(lab);ui.appendChild(document.createElement('br'));});
document.getElementById('mode').onchange=function(){colorMode=+this.value;};
document.getElementById('psize').oninput=function(){psize=+this.value;};
const slider=document.getElementById('iter');
if(slider){
 if(iterPoses){slider.max=iterPoses.length-1;slider.value=iter;
  slider.oninput=function(){iter=+this.value;
   document.getElementById('iterlab').textContent='iteration '+iter;
   updatePairs();};}
 else{slider.parentElement.style.display='none';}}
"""

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body{{margin:0;font:13px sans-serif;background:#14161a;color:#ddd;
      display:flex;height:100vh;overflow:hidden}}
 #panel{{width:240px;padding:10px;background:#1d2026;overflow-y:auto}}
 #gl{{flex:1;width:100%;height:100%}}
 h2{{font-size:15px;margin:4px 0}}
 .hint{{color:#888;font-size:11px}}
 select,input[type=range]{{width:100%}}
</style></head>
<body>
<div id="panel">
 <h2>{title}</h2>
 <div class="hint">drag: orbit &middot; right-drag: pan &middot;
  wheel: zoom</div>
 <p>colour mode:
  <select id="mode">
   <option value="1" selected>scalar (height / intensity / occ)</option>
   <option value="0">by layer</option>
  </select></p>
 <p>point size <input type="range" id="psize" min="1" max="8"
  step="0.5" value="2"></p>
 <p><span id="iterlab">iteration</span>
  <input type="range" id="iter" min="0" max="0" value="0"></p>
 <div id="layers"></div>
 <pre class="hint">{summary}</pre>
</div>
<canvas id="gl"></canvas>
<script>
const DATA={data_json};
const PALETTE={palette_json};
{js}
</script>
</body></html>
"""


def _emit(path, title, data, summary=""):
    doc = _HTML.format(
        title=html.escape(title),
        summary=html.escape(summary),
        data_json=json.dumps(data),
        palette_json=json.dumps(_PALETTE),
        js=_JS,
    )
    with open(path, "w") as f:
        f.write(doc)


def export_map_html(mm, path, max_points_per_layer: int = 400_000,
                    trajectory=None, title: str = "mm-viewer") -> None:
    """Standalone interactive HTML for a MetricMap (or layers dict).
    ``trajectory``: optional [N, 3] polyline (e.g. TUM/KITTI keyframe
    positions — the reference mm-viewer's trajectory overlay)."""
    data = {
        "layers": _collect_layers(mm, max_points_per_layer),
        "traj": (
            None if trajectory is None
            else _b64(to_numpy(trajectory).astype(np.float32).reshape(-1, 3))
        ),
        "iters": None,
        "pairs": None,
    }
    summary = (
        mm.contents_summary() if hasattr(mm, "contents_summary") else ""
    )
    _emit(path, title, data, summary)


def export_icplog_html(log: dict, path, max_points_per_layer: int = 300_000,
                       title: str = "icp-log-viewer") -> None:
    """Standalone interactive HTML for a loaded .icplog record (io.icplog
    .load_log output): global map static, LOCAL map re-posed live by the
    iteration slider; recorded decimated pairings drawn as lines — the
    reference icp-log-viewer's core workflow."""
    layers = []
    for prefix, mark_local in (("global", False), ("local", True)):
        for name, pc in log.get(prefix, {}).items():
            pts = to_numpy(pc.xyz)[: int(pc.count)]
            pts, _ = _decimate(pts, None, max_points_per_layer)
            if pts.shape[0] == 0:
                continue
            layers.append({
                "name": f"{prefix}/{name}", "kind": "points",
                "n": int(pts.shape[0]), "xyz": _b64(pts), "scalar": None,
                "local": mark_local,
            })
    iters = None
    pairs = None
    if "iterations" in log:
        its = log["iterations"]
        Rs = to_numpy(its["poses"].R).astype(np.float32)  # [N, 3, 3]
        ts = to_numpy(its["poses"].t).astype(np.float32)  # [N, 3]
        iters = [
            list(map(float, list(Rs[i].reshape(-1)) + list(ts[i])))
            for i in range(Rs.shape[0])
        ]
        if "pairings" in its:
            p = its["pairings"].pt2pt
            w = to_numpy(p.weight)  # [N, C]
            loc = to_numpy(p.local).astype(np.float32)
            glo = to_numpy(p.globl).astype(np.float32)
            pairs = []
            for i in range(w.shape[0]):
                m = w[i] > 0
                pairs.append({
                    "l": _b64(loc[i][m]),
                    "g": _b64(glo[i][m]),
                })
    meta = log.get("meta", {})
    summary = "\n".join(f"{k}: {v}" for k, v in meta.items())
    data = {"layers": layers, "traj": None, "iters": iters, "pairs": pairs}
    _emit(path, title, data, summary)
