"""Plain rasterizer: the reference of the rasterized cells.

For chosen pixels it scans every triangle of a `RefScene` with the
rasterizer's documented arithmetic: world corners through view and
projection to screen space, edge functions and the three-term depth sum
rounded as fused multiply-adds (emulated exactly in float64), coverage
on the edge's sign, the reverse-Z greater depth test, perspective-
correct barycentrics; then the forward shading the renderer documents
(Oren-Nayar against every quad light toward its centre with the light's
cosine and no shadows, base-colour maps bilinear at level 0, the clear
colour on the background) and the simple ACES post pass. A pixel whose
winner differs (a centre exactly on a shared edge, or two surfaces at the
same depth) differs. Nothing of the program is imported.
"""

from __future__ import annotations

import torch

from .reftrace import build_basis, cross, dot, normalize, oren_nayar, sample_map, to_local

CLEAR_COLOR = (25.0 / 255.0, 118.0 / 255.0, 210.0 / 255.0)
PIX_CHUNK = 1024
TRI_CHUNK = 4096


def fma(a, b, c, dt):
    """a * b + c rounded once to dt (float32), emulated in float64; in a
    lower precision dt the operands and the result are simply rounded."""
    if dt != torch.float32:
        return (a * b + c).to(dt)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def edge(dx, dy, rx, ry, dt):
    return fma(dx, ry, -(dy * rx), dt)


def screen_triangles(rs, width: int, height: int):
    """Screen xy (T, 3, 2), reverse-Z depth (T, 3), 1/w (T, 3) and the
    validity (all corners in front of the camera) of every triangle."""
    dev, dt = rs.device, rs.dtype
    view = torch.as_tensor(rs.view_matrix).to(dev, dt)
    proj = torch.as_tensor(rs.proj_matrix).to(dev, dt)
    vp = proj @ view
    corners = torch.stack([rs.v0, rs.v0 + rs.e1, rs.v0 + rs.e2], dim=1)
    pos = corners.reshape(-1, 3)
    homo = torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1)
    clip = (homo @ vp.T).reshape(-1, 3, 4)
    w = clip[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    inv_w = 1.0 / safe_w
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    valid = (rs.tri_mat >= 0) & torch.all(clip[..., 3] > 1e-6, dim=-1)
    return torch.stack([sx, sy], dim=-1), ndc[..., 2], inv_w, valid


def fragments(rs, pixels, width: int, height: int):
    """(tri, u, v) of the visible triangle at each pixel centre (tri -1
    and u = v = 0 on the background)."""
    dev, dt = rs.device, rs.dtype
    scr, dep, inv_w, valid = screen_triangles(rs, width, height)
    x0, y0 = scr[:, 0, 0], scr[:, 0, 1]
    x1, y1 = scr[:, 1, 0], scr[:, 1, 1]
    x2, y2 = scr[:, 2, 0], scr[:, 2, 1]
    area = edge(x1 - x0, y1 - y0, x2 - x0, y2 - y0, dt)
    sgn = torch.where(area >= 0, 1.0, -1.0).to(dt)
    inv_area = 1.0 / torch.where(torch.abs(area) > 1e-12, area, 1.0)
    ok = valid & (torch.abs(area) > 1e-12)
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    px_all = (pix % width).to(dt) + 0.5
    py_all = (pix // width).to(dt) + 0.5
    out_tri, out_u, out_v = [], [], []
    t_count = scr.shape[0]
    for p0 in range(0, pix.numel(), PIX_CHUNK):
        px = px_all[p0:p0 + PIX_CHUNK, None]
        py = py_all[p0:p0 + PIX_CHUNK, None]
        n = px.shape[0]
        depth = torch.zeros(n, dtype=dt, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        uw = torch.zeros(n, dtype=dt, device=dev)
        vw = torch.zeros(n, dtype=dt, device=dev)
        iw = torch.zeros(n, dtype=dt, device=dev)
        for c0 in range(0, t_count, TRI_CHUNK):
            sl = slice(c0, c0 + TRI_CHUNK)
            a0x, a0y, a1x, a1y, a2x, a2y = (v[None, sl] for v in (x0, y0, x1, y1, x2, y2))
            s = sgn[None, sl]
            w0 = edge(a2x - a1x, a2y - a1y, px - a1x, py - a1y, dt)
            w1 = edge(a0x - a2x, a0y - a2y, px - a2x, py - a2y, dt)
            w2 = edge(a1x - a0x, a1y - a0y, px - a0x, py - a0y, dt)
            inside = (w0 * s >= 0.0) & (w1 * s >= 0.0) & (w2 * s >= 0.0) & ok[None, sl]
            ia = inv_area[None, sl]
            l0, l1, l2 = w0 * ia, w1 * ia, w2 * ia
            d = dep[sl]
            z = fma(l2, d[None, :, 2], fma(l0, d[None, :, 0], l1 * d[None, :, 1], dt), dt)
            z = torch.where(inside, z, -1.0)
            z_best = torch.amax(z, dim=-1)
            cols = torch.arange(z.shape[1], device=dev)
            first = torch.where((z == z_best[:, None]) & inside, cols, z.shape[1])
            loc = torch.clamp(torch.amin(first, dim=-1), max=z.shape[1] - 1)
            rows = torch.arange(n, device=dev)
            iwc = inv_w[sl][loc]
            l0w, l1w, l2w = l0[rows, loc], l1[rows, loc], l2[rows, loc]
            uw_c = l1w * iwc[:, 1]
            vw_c = l2w * iwc[:, 2]
            iw_c = fma(l2w, iwc[:, 2], fma(l0w, iwc[:, 0], uw_c, dt), dt)
            better = z_best > depth
            depth = torch.where(better, z_best, depth)
            tri = torch.where(better, c0 + loc, tri)
            uw = torch.where(better, uw_c, uw)
            vw = torch.where(better, vw_c, vw)
            iw = torch.where(better, iw_c, iw)
        den = torch.clamp(iw, min=1e-12)
        out_tri.append(tri)
        out_u.append(uw / den)
        out_v.append(vw / den)
    return torch.cat(out_tri), torch.cat(out_u), torch.cat(out_v)


def aces_simple(c):
    a, b, y, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (y * c + d) + e), 0.0, 1.0)


def render_pixels(rs, pixels, width: int, height: int):
    """(P, 10): the post-processed colour, the albedo, the shading
    normal and the coverage (1 where a triangle covers the pixel)."""
    dt = rs.dtype
    tri, u, v = fragments(rs, pixels, width, height)
    tid = torch.clamp(tri, min=0)
    w0 = 1.0 - u - v
    nrm = rs.normals[tid]
    ns = normalize(w0[:, None] * nrm[:, 0] + u[:, None] * nrm[:, 1] + v[:, None] * nrm[:, 2])
    pos = rs.v0[tid] + u[:, None] * rs.e1[tid] + v[:, None] * rs.e2[tid]
    to_view = rs.cam_pos[None, :] - pos
    ns = torch.where(dot(ns, to_view)[:, None] < 0, -ns, ns)
    uvs = rs.uvs[tid]
    uv = w0[:, None] * uvs[:, 0] + u[:, None] * uvs[:, 1] + v[:, None] * uvs[:, 2]
    mat = torch.clamp(rs.tri_mat[tid], min=0)
    base = rs.mat_base[mat]
    if rs.textures is not None:
        base = base * sample_map(rs, rs.mat_map[mat], uv)[:, :3]
    t_b, b_b = build_basis(ns)
    wo = normalize(to_view)
    wo_l = to_local(wo, t_b, b_b, ns)
    wo_l = torch.cat([wo_l[:, :2], torch.clamp(wo_l[:, 2:3], min=1e-5)], dim=1)
    color = torch.zeros_like(base)
    for li in range(rs.num_lights):
        lpos, lu, lv = rs.light_corner[li], rs.light_u[li], rs.light_v[li]
        inten, area = rs.light_rad[li], rs.light_area[li]
        lcenter = lpos + 0.5 * (lu + lv)
        to_l = lcenter[None, :] - pos
        d2 = torch.clamp(dot(to_l, to_l), min=1e-6)
        wi = to_l / torch.sqrt(d2)[:, None]
        n_q = normalize(cross(lu, lv))
        cos_l = torch.clamp(-dot(wi, n_q[None, :]), min=0.0)
        rad = inten[None, :] * (area * cos_l / d2)[:, None]
        wi_l = to_local(wi, t_b, b_b, ns)
        f, _ = oren_nayar(base, rs.mat_a[mat], rs.mat_b[mat], wo_l, wi_l)
        cos_i = torch.clamp(wi_l[:, 2], min=0.0)
        color = color + f * rad * cos_i[:, None]
    clear = torch.tensor(CLEAR_COLOR, dtype=torch.float32).to(rs.device, dt)
    covered = tri >= 0
    color = torch.where(covered[:, None], color, clear[None, :])
    return torch.cat([aces_simple(color), base, ns, covered.to(dt)[:, None]], dim=1)
