"""Offline interactive map viewer: one self-contained HTML file.

Viewer parity for the reference's live ROS visualizer (ref:
/root/reference/gmmloc/src/visualization/visualizer.cpp:150-221 —
keyframe frustums + covisibility graph; campose_visualizer.h:13-54 —
frustum marker geometry; gmm_visualizer.cpp — component ellipsoids).
Instead of a 30 Hz ROS thread, this renders the world state (live
MapState or a saved checkpoint) into a single HTML file with an
embedded canvas renderer — drag to orbit, wheel to zoom, keys to toggle
layers. No external assets or network access (zero-egress rule).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..mapping.map_state import MapState, _quat_to_mat


def _frustum_segments(q_cw, t_cw, scale=0.12):
    """Camera frustum wireframe (campose_visualizer.h geometry)."""
    R_cw = _quat_to_mat(q_cw)
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    w, h, z = 0.8 * scale, 0.5 * scale, 0.6 * scale
    corners = np.array(
        [[-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]]
    ) @ R_cw + c
    segs = []
    for i in range(4):
        segs.append((c, corners[i]))
        segs.append((corners[i], corners[(i + 1) % 4]))
    return segs


def _ellipsoid_wires(mean, cov, n=12, k=2.0):
    """Three principal-plane wire rings of the k-sigma ellipsoid."""
    vals, vecs = np.linalg.eigh(cov)
    vals = np.clip(vals, 1e-12, None)
    axes = vecs * (k * np.sqrt(vals))[None, :]
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rings = []
    for (a, b) in ((0, 1), (0, 2), (1, 2)):
        ring = (
            mean[None, :]
            + np.outer(np.cos(th), axes[:, a])
            + np.outer(np.sin(th), axes[:, b])
        )
        rings.append(ring)
    return rings


def export_html(
    world: MapState,
    path: str,
    gmm=None,
    max_points: int = 8000,
    max_ellipsoids: int = 400,
    covis_min: int = 30,
) -> str:
    """Write the interactive viewer. `gmm` is an optional GMMMap (or
    host view dict with means/covs) for the prior-map ellipsoid layer."""
    kfs = [k for k in range(world.MK) if world.kf_valid[k]]
    frusta = []
    for k in kfs:
        for a, b in _frustum_segments(world.kf_q[k], world.kf_t[k]):
            frusta.append([a.tolist(), b.tolist()])

    centers = {}
    for k in kfs:
        R = _quat_to_mat(world.kf_q[k])
        centers[k] = (-R.T @ world.kf_t[k]).tolist()
    covis = []
    for i, k in enumerate(kfs):
        for k2 in kfs[i + 1:]:
            wgt = int(world.covis[k, k2])
            if wgt >= covis_min:
                covis.append([centers[k], centers[k2]])

    pts_idx = np.where(world.pt_valid)[0]
    if len(pts_idx) > max_points:
        pts_idx = pts_idx[:: len(pts_idx) // max_points + 1]
    pts = world.pt_pos[pts_idx].tolist()

    traj = []
    for fi in world.frame_infos:
        if fi.ref_kf >= 0 and world.kf_valid[fi.ref_kf]:
            import gmmloc.mapping.map_state as ms

            q_cr, t_cr = ms._inverse(fi.q_cr, fi.t_cr)
            q, t = ms._compose(
                q_cr, t_cr, world.kf_q[fi.ref_kf], world.kf_t[fi.ref_kf]
            )
            R = _quat_to_mat(q)
            traj.append((-R.T @ t).tolist())

    ellipsoids = []
    if gmm is not None:
        means = np.asarray(getattr(gmm, "means", gmm.get("means") if isinstance(gmm, dict) else None))
        covs = getattr(gmm, "covs", gmm.get("covs") if isinstance(gmm, dict) else None)
        if covs is not None:
            covs = np.asarray(covs)
            n = min(max_ellipsoids, len(means))
            for i in range(n):
                for ring in _ellipsoid_wires(means[i], covs[i]):
                    ellipsoids.append(ring.tolist())

    data = {
        "frusta": frusta, "covis": covis, "points": pts,
        "traj": traj, "ellipsoids": ellipsoids,
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gmmloc map</title>
<style>
 body{margin:0;background:#101014;color:#ccc;font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;user-select:none}
 canvas{display:block}
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: zoom &middot; keys:
 [p]oints [f]rusta [c]ovis [e]llipsoids [t]rajectory</div>
<canvas id="cv"></canvas>
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let az = 0.6, el = 0.4, zoom = 80, cx = 0, cy = 0;
let show = {p:true, f:true, c:true, e:true, t:true};
function center(){
  let s=[0,0,0], n=0;
  for(const p of D.points){s[0]+=p[0];s[1]+=p[1];s[2]+=p[2];n++;}
  if(n){return [s[0]/n,s[1]/n,s[2]/n];} return [0,0,0];
}
const C = center();
function proj(p){
  const x=p[0]-C[0], y=p[1]-C[1], z=p[2]-C[2];
  const ca=Math.cos(az), sa=Math.sin(az), ce=Math.cos(el), se=Math.sin(el);
  const x1=ca*x+sa*y, y1=-sa*x+ca*y;
  const y2=ce*y1-se*z, z2=se*y1+ce*z;
  return [cv.width/2+cx+zoom*x1, cv.height/2+cy-zoom*z2, y2];
}
function seg(a,b,st){const A=proj(a),B=proj(b);ctx.strokeStyle=st;
  ctx.beginPath();ctx.moveTo(A[0],A[1]);ctx.lineTo(B[0],B[1]);ctx.stroke();}
function draw(){
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,cv.width,cv.height);
  if(show.p){ctx.fillStyle='#8fa7c9';
    for(const p of D.points){const P=proj(p);ctx.fillRect(P[0],P[1],1.5,1.5);}}
  if(show.e){ctx.lineWidth=0.5;
    for(const ring of D.ellipsoids){for(let i=0;i<ring.length;i++)
      seg(ring[i], ring[(i+1)%ring.length], 'rgba(120,200,140,0.35)');}}
  if(show.c){ctx.lineWidth=0.6;
    for(const [a,b] of D.covis) seg(a,b,'rgba(220,180,80,0.5)');}
  if(show.f){ctx.lineWidth=1.0;
    for(const [a,b] of D.frusta) seg(a,b,'#d06a6a');}
  if(show.t && D.traj.length>1){ctx.lineWidth=1.2;
    for(let i=1;i<D.traj.length;i++) seg(D.traj[i-1],D.traj[i],'#6ad0c0');}
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  az+=(e.clientX-lx)*0.01; el+=(e.clientY-ly)*0.01;
  lx=e.clientX; ly=e.clientY; draw();};
window.onwheel=e=>{zoom*=e.deltaY<0?1.1:0.9; draw();};
window.onkeydown=e=>{const k=e.key.toLowerCase();
  if(k in show){show[k]=!show[k]; draw();}};
window.onresize=draw;
draw();
</script></body></html>
"""
