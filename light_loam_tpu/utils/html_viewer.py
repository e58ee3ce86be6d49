"""Interactive 3-D map viewer — single self-contained HTML file.

The reference's live visualization surface is rviz (config at
rviz_cfg/aloam_velodyne.rviz: path overlays at :82,132,189, cloud displays
at :217,247,277) — an interactive orbit/pan/zoom 3-D view of the map
clouds and trajectories.  A headless GPU server has no display, so the
equivalent here is an *exported* interactive viewer: one HTML file with the
point clouds embedded as base64 float32 and ~150 lines of vanilla
canvas-2D JavaScript (orbit = drag, pan = shift-drag, zoom = wheel, color
by height or cloud).  Opens in any browser, no network, no dependencies.

Complements `utils/viz.py` (static PNG quick-looks) and `utils/export.py`
(PLY for external 3-D tools).
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence, Tuple

import numpy as np

# cloud name -> fixed RGB used when height-coloring is toggled off
_DEFAULT_COLORS = {
    "surf": (110, 170, 255),
    "corner": (255, 150, 60),
    "trajectory": (255, 60, 60),
    "gt": (90, 220, 120),
}


def _pack_points(xyz: np.ndarray, mask: Optional[np.ndarray],
                 max_points: int) -> np.ndarray:
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    if mask is not None:
        xyz = xyz[np.asarray(mask).astype(bool).reshape(-1)]
    if len(xyz) > max_points:
        idx = np.random.default_rng(0).choice(len(xyz), max_points,
                                              replace=False)
        xyz = xyz[np.sort(idx)]
    return np.ascontiguousarray(xyz, dtype=np.float32)


def export_html(
    path: str,
    clouds: Sequence[Tuple[str, np.ndarray, Optional[np.ndarray]]],
    trajectories: Sequence[Tuple[str, np.ndarray]] = (),
    title: str = "light-loam-tpu map viewer",
    max_points: int = 250_000,
) -> str:
    """Write an interactive HTML viewer.

    ``clouds``: [(name, xyz (N,3), mask-or-None), ...] point sets.
    ``trajectories``: [(name, positions (N,3)), ...] rendered as polylines.
    """
    payload = {"clouds": [], "paths": [], "title": title}
    for name, xyz, mask in clouds:
        pts = _pack_points(xyz, mask, max_points)
        payload["clouds"].append({
            "name": name,
            "n": int(len(pts)),
            "rgb": list(_DEFAULT_COLORS.get(name, (200, 200, 200))),
            "b64": base64.b64encode(pts.tobytes()).decode("ascii"),
        })
    for name, pos in trajectories:
        pos = np.ascontiguousarray(np.asarray(pos, np.float32).reshape(-1, 3))
        payload["paths"].append({
            "name": name,
            "n": int(len(pos)),
            "rgb": list(_DEFAULT_COLORS.get(name, (255, 60, 60))),
            "b64": base64.b64encode(pos.tobytes()).decode("ascii"),
        })

    html = _TEMPLATE.replace("__PAYLOAD__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>light-loam-tpu viewer</title>
<style>
 html,body{margin:0;height:100%;background:#101216;color:#cfd6e4;
   font:13px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;line-height:1.5;z-index:2;
   background:rgba(16,18,22,.75);padding:6px 10px;border-radius:6px}
 #hud b{color:#fff}
 canvas{display:block}
 .sw{display:inline-block;width:9px;height:9px;border-radius:2px;
   margin-right:4px}
</style></head><body>
<div id="hud"></div><canvas id="cv"></canvas>
<script>
const P = __PAYLOAD__;
function unpack(b64){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);
 return new Float32Array(u.buffer);}
for(const c of P.clouds.concat(P.paths)) c.pts=unpack(c.b64);

const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let W,H;function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize();addEventListener('resize',()=>{resize();draw();});

// center on the data
let cx=0,cy=0,cz=0,n=0,zmin=1e9,zmax=-1e9;
for(const c of P.clouds){const p=c.pts;
 for(let i=0;i<p.length;i+=3){cx+=p[i];cy+=p[i+1];cz+=p[i+2];n++;
  if(p[i+2]<zmin)zmin=p[i+2];if(p[i+2]>zmax)zmax=p[i+2];}}
if(n){cx/=n;cy/=n;cz/=n;}else{zmin=0;zmax=1;}
let yaw=-0.7,pitch=0.9,dist=80,panx=0,pany=0,heightColor=true;

function draw(){
 ctx.fillStyle='#101216';ctx.fillRect(0,0,W,H);
 const cyaw=Math.cos(yaw),syaw=Math.sin(yaw),
       cp=Math.cos(pitch),sp=Math.sin(pitch),
       f=0.9*Math.min(W,H),zr=Math.max(zmax-zmin,1e-3);
 function proj(x,y,z){
  x-=cx;y-=cy;z-=cz;
  const rx=cyaw*x-syaw*y, ry=syaw*x+cyaw*y;
  const vz=cp*ry+sp*z, vy=-sp*ry+cp*z;       // camera looks along +vz
  const d=vz+dist; if(d<0.5)return null;
  return [W/2+panx+f*rx/d, H/2+pany-f*vy/d, d];
 }
 const img=ctx.createImageData(W,H),buf=img.data;
 for(const c of P.clouds){
  const p=c.pts,[r0,g0,b0]=c.rgb;
  for(let i=0;i<p.length;i+=3){
   const q=proj(p[i],p[i+1],p[i+2]); if(!q)continue;
   const x=q[0]|0,y=q[1]|0; if(x<0||y<0||x>=W||y>=H)continue;
   let r=r0,g=g0,b=b0;
   if(heightColor){const t=(p[i+2]-zmin)/zr;      // turbo-ish ramp
    r=Math.min(255,80+340*t); g=60+160*Math.sin(3.14*t); b=220-180*t;}
   const o=4*(y*W+x);buf[o]=r;buf[o+1]=g;buf[o+2]=b;buf[o+3]=255;
  }}
 ctx.putImageData(img,0,0);
 for(const c of P.paths){
  const p=c.pts;ctx.strokeStyle=`rgb(${c.rgb})`;ctx.lineWidth=2;
  ctx.beginPath();let started=false;
  for(let i=0;i<p.length;i+=3){
   const q=proj(p[i],p[i+1],p[i+2]);if(!q){started=false;continue;}
   if(started)ctx.lineTo(q[0],q[1]);else{ctx.moveTo(q[0],q[1]);started=true;}
  }
  ctx.stroke();}
 let hud=`<b>${P.title}</b><br>`;
 for(const c of P.clouds)hud+=`<span class=sw style="background:rgb(${c.rgb})"></span>${c.name}: ${c.n} pts<br>`;
 for(const c of P.paths)hud+=`<span class=sw style="background:rgb(${c.rgb})"></span>${c.name}: ${c.n} poses<br>`;
 hud+=`drag orbit · shift-drag pan · wheel zoom · <u>c</u> color: ${heightColor?'height':'cloud'}`;
 document.getElementById('hud').innerHTML=hud;
}
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY,e.shiftKey]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panx+=dx;pany+=dy;}
 else{yaw+=dx*0.008;pitch=Math.max(0.02,Math.min(1.55,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];draw();});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);
 dist=Math.max(2,Math.min(2000,dist));draw();e.preventDefault();},
 {passive:false});
addEventListener('keydown',e=>{if(e.key=='c'){heightColor=!heightColor;draw();}});
draw();
</script></body></html>
"""


def export_pipeline_html(pipe, path: str,
                         gt: Optional[np.ndarray] = None) -> str:
    """One-call interactive viewer for a `models.pipeline.Pipeline`:
    corner+surf map stores plus mapped (and optional GT) trajectories."""
    from light_loam_tpu.models.mapping import full_map_cloud

    # mapped_positions() retires any in-flight mapping step
    # (pipeline._retire_mapping(wait=True)), so the map_state read BELOW
    # it is the post-retirement one — keep this call first.
    mapped = pipe.mapped_positions()
    (cxz, cm), (sxz, sm) = full_map_cloud(pipe.map_state)
    clouds = [
        ("surf", np.asarray(sxz), np.asarray(sm)),
        ("corner", np.asarray(cxz), np.asarray(cm)),
    ]
    paths = []
    if gt is not None:
        paths.append(("gt", np.asarray(gt)))
    if len(mapped) >= 2:
        paths.append(("trajectory", np.asarray(mapped)))
    return export_html(path, clouds, paths)
