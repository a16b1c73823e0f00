"""BSDF library with masked selection over material kinds.

Counterpart of ``mitsuba3_experiments_tpu.render.bsdf.dispatch``: every lane
evaluates every lobe family present in the scene and the per-lane result is
selected by the `kind` column.

Conventions (Mitsuba-compatible):
  * all directions in the local shading frame, +z = normal;
  * `eval` returns f(wi->wo) * |cos theta_o|; zero for delta lobes;
  * `pdf` is the solid-angle density of `sample`; zero for delta lobes;
  * `sample` returns (BSDFSample, weight = f * cos / pdf) — for delta lobes
    the weight carries the full throughput and pdf is the discrete prob;
  * one-sided materials respond only for wi.z > 0; `twosided` rows flip the
    frame for back-side hits.
"""
from __future__ import annotations

import torch

from ...core import math as m
from ...core import warp
from ...core.records import BSDFFlags, BSDFSample
from ...scene.types import BSDFKind, MaterialTable
from .. import fresnel as fr
from .. import microfacet as mf
from ..texture import eval_texture

_MIN_ALPHA = 1e-3


def _gather_rows(mats: MaterialTable, mat_id):
    """Per-lane material columns, resolving one MASK nesting level.

    The float columns a gradient may flow into (base_color, params) are
    read with index_select, whose backward is an index_add_: the backward
    of advanced indexing, a sorted index_put_, serializes the many lanes
    that share one of a table's few rows, and dominated a replay chunk's
    device time on the card."""
    mid = torch.clamp(mat_id, min=0).long()
    kind = mats.kind[mid]
    nested = mats.nested_id[mid]
    is_mask = kind == BSDFKind.MASK
    eff = torch.where(is_mask, torch.clamp(nested, min=0).long(), mid)
    return dict(
        kind=mats.kind[eff],
        base_color=mats.base_color.index_select(0, eff),
        params=mats.params.index_select(0, eff),
        tex_id=mats.tex_id[eff],
        twosided=mats.twosided[mid] | mats.twosided[eff],
        flags=mats.flags[mid],
        is_mask=is_mask,
        opacity=torch.where(is_mask[:, None], mats.base_color.index_select(0, mid), 1.0),
        opacity_tex=torch.where(is_mask, mats.tex_id[mid], -1),
    )


def bsdf_flags(mats: MaterialTable, mat_id):
    return mats.flags[torch.clamp(mat_id, min=0).long()]


def base_color(mats: MaterialTable, textures, si):
    """Per-lane base colour, texture-resolved: a property fetched off the
    lane's BSDF (the reference's dr.dispatch property read)."""
    return _albedo(_gather_rows(mats, si.mat_id), textures, si.uv)


def _albedo(row, textures, uv):
    base = row["base_color"]
    tex = eval_texture(textures, row["tex_id"], uv)
    return torch.where((row["tex_id"] >= 0)[:, None], base * tex, base)


def _clip(x, lo: float, hi: float):
    """jnp.clip with its gradient: minimum(maximum(x, lo), hi), which gives
    half the gradient where x equals a bound (torch.clamp gives all of it).
    The bounds are filled on x's device (no copy from the host)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _opacity(row, textures, uv):
    op = row["opacity"]
    tex = eval_texture(textures, row["opacity_tex"], uv)
    return _clip(torch.where((row["opacity_tex"] >= 0)[:, None], tex, op), 0.0, 1.0)


def _with_z(v, z):
    return torch.cat([v[..., :2], z[..., None]], dim=-1)


def _flip_frame(row, wi, wo=None):
    """twosided adapter: flip z for back-side interactions of twosided
    non-transmissive materials (dielectrics handle sides natively)."""
    transmissive = (row["kind"] == BSDFKind.DIELECTRIC) | (
        row["kind"] == BSDFKind.ROUGH_DIELECTRIC
    ) | (row["kind"] == BSDFKind.NULL)
    flip = row["twosided"] & (wi[..., 2] < 0.0) & ~transmissive
    s = torch.where(flip, -1.0, 1.0)
    wi_f = _with_z(wi, wi[..., 2] * s)
    if wo is None:
        return wi_f, s
    return wi_f, _with_z(wo, wo[..., 2] * s), s


# ===========================================================================
# Per-kind eval/pdf (smooth lobes; deltas return 0)
# ===========================================================================

_ALL_KINDS = frozenset(range(BSDFKind.COUNT))


def _as_present(present):
    """Kinds filter: () / None = unknown = assume all kinds."""
    return _ALL_KINDS if not present else frozenset(present)


def _eval_pdf_kinds(row, albedo, wi, wo, present=None):
    """Returns (f (N,3), pdf (N,)) selected per lane by kind.  Lobe families
    absent from `present` are skipped."""
    present = _as_present(present)
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    zero3 = torch.zeros_like(wi)
    zero = torch.zeros_like(cos_i)
    f_tab: dict = {}
    pdf_tab: dict = {}

    reflect_side = (cos_i > 0.0) & (cos_o > 0.0)

    need_ggx = present & {
        BSDFKind.ROUGH_CONDUCTOR, BSDFKind.ROUGH_PLASTIC, BSDFKind.PRINCIPLED
    }
    need_pl = present & {BSDFKind.PLASTIC, BSDFKind.ROUGH_PLASTIC}

    # ---- diffuse ----------------------------------------------------------
    if BSDFKind.DIFFUSE in present:
        f_diff = albedo * (m.INV_PI * torch.clamp(cos_o, min=0.0))[:, None]
        f_tab[BSDFKind.DIFFUSE] = torch.where(reflect_side[:, None], f_diff, 0.0)
        pdf_tab[BSDFKind.DIFFUSE] = torch.where(
            reflect_side, warp.square_to_cosine_hemisphere_pdf(wo), 0.0
        )

    alpha = torch.clamp(row["params"][:, 6], min=_MIN_ALPHA)
    eta = torch.clamp(row["params"][:, 0], min=1e-3)
    if need_ggx:
        h = m.normalize(wi + wo)
        h = h * m.sign_not_zero(h[..., 2])[..., None]
        D = mf.ggx_d(h, alpha)
        G = mf.smith_g(wi, wo, h, alpha)
        pdf_ggx_wo = m.safe_div(mf.pdf_ggx(h, alpha), 4.0 * torch.abs(m.dot(wo, h)))

    # ---- rough conductor --------------------------------------------------
    if BSDFKind.ROUGH_CONDUCTOR in present:
        F_c = fr.fresnel_conductor(m.dot(wi, h), row["params"][:, 0:3], row["params"][:, 3:6])
        spec = m.safe_div(D * G, 4.0 * torch.abs(cos_i))
        f_rc = albedo * F_c * spec[:, None]
        f_tab[BSDFKind.ROUGH_CONDUCTOR] = torch.where(reflect_side[:, None], f_rc, 0.0)
        pdf_tab[BSDFKind.ROUGH_CONDUCTOR] = torch.where(reflect_side, pdf_ggx_wo, 0.0)

    # ---- rough dielectric -------------------------------------------------
    if BSDFKind.ROUGH_DIELECTRIC in present:
        f_rd, pdf_rd = _rough_dielectric_eval_pdf(row, albedo, wi, wo, eta, alpha)
        f_tab[BSDFKind.ROUGH_DIELECTRIC] = f_rd
        pdf_tab[BSDFKind.ROUGH_DIELECTRIC] = pdf_rd

    # ---- plastic (smooth): only the diffuse part is smooth -----------------
    # f_diff = rho/pi * (1-F(wi))(1-F(wo)) / eta^2 / (1 - fdr_int)
    if need_pl:
        F_i = fr.fresnel_dielectric(cos_i, eta)[0]
        F_o = fr.fresnel_dielectric(cos_o, eta)[0]
        fdr_int = fr.fresnel_diffuse_reflectance(1.0 / eta)
        inv_eta2 = 1.0 / (eta * eta)
        diff_pl = albedo * m.safe_div(
            (1.0 - F_i) * (1.0 - F_o) * m.INV_PI * inv_eta2
            * torch.clamp(cos_o, min=0.0),
            (1.0 - fdr_int),
        )[:, None]
    if BSDFKind.PLASTIC in present:
        f_tab[BSDFKind.PLASTIC] = torch.where(reflect_side[:, None], diff_pl, 0.0)
        pdf_tab[BSDFKind.PLASTIC] = torch.where(
            reflect_side, (1.0 - F_i) * warp.square_to_cosine_hemisphere_pdf(wo), 0.0
        )

    # ---- rough plastic: GGX specular + diffuse ---------------------------
    if BSDFKind.ROUGH_PLASTIC in present:
        F_h = fr.fresnel_dielectric(m.dot(wi, h), eta)[0]
        spec_rp = m.safe_div(D * G * F_h, 4.0 * torch.abs(cos_i))
        f_tab[BSDFKind.ROUGH_PLASTIC] = torch.where(
            reflect_side[:, None], spec_rp[:, None] + diff_pl, 0.0
        )
        prob_spec_rp = torch.clamp(F_i, 0.25, 0.75)
        pdf_tab[BSDFKind.ROUGH_PLASTIC] = torch.where(
            reflect_side,
            prob_spec_rp * pdf_ggx_wo
            + (1.0 - prob_spec_rp) * warp.square_to_cosine_hemisphere_pdf(wo),
            0.0,
        )

    # ---- principled (Disney-style metallic/roughness subset) --------------
    if BSDFKind.PRINCIPLED in present:
        metallic = row["params"][:, 0]
        spec_amt = row["params"][:, 1]
        f0 = (0.08 * spec_amt * (1.0 - metallic))[:, None] + albedo * metallic[:, None]
        F_schlick = f0 + (1.0 - f0) * torch.clamp(
            1.0 - torch.abs(m.dot(wi, h)), 0.0, 1.0
        )[:, None] ** 5
        spec_pr = m.safe_div(D * G, 4.0 * torch.abs(cos_i))
        diff_pr = albedo * ((1.0 - metallic) * m.INV_PI * torch.clamp(cos_o, min=0.0))[:, None]
        f_tab[BSDFKind.PRINCIPLED] = torch.where(
            reflect_side[:, None], diff_pr + F_schlick * spec_pr[:, None], 0.0
        )
        p_spec_prn = torch.clamp(0.25 + 0.5 * metallic, 0.25, 0.9)
        pdf_tab[BSDFKind.PRINCIPLED] = torch.where(
            reflect_side,
            p_spec_prn * pdf_ggx_wo
            + (1.0 - p_spec_prn) * warp.square_to_cosine_hemisphere_pdf(wo),
            0.0,
        )

    kind = row["kind"]
    return _select_kind(kind, f_tab, zero3), _select_kind(kind, pdf_tab, zero)


def _select_kind(kind, table: dict, default):
    out = default
    for k, v in table.items():
        mask = kind == k
        out = torch.where(mask.reshape(mask.shape + (1,) * (v.dim() - mask.dim())), v, out)
    return out


def _rough_dielectric_eval_pdf(row, albedo, wi, wo, eta, alpha):
    """Walter-style rough dielectric (reflection + refraction lobes)."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    is_reflect = cos_i * cos_o > 0.0
    eta_it = torch.where(cos_i >= 0.0, eta, 1.0 / eta)

    # half vector: reflection vs refraction form
    h_refl = m.normalize(wi + wo)
    h_refr = m.normalize(wi + wo * eta_it[..., None])
    h = torch.where(is_reflect[..., None], h_refl, h_refr)
    h = h * m.sign_not_zero(h[..., 2])[..., None]

    D = mf.ggx_d(h, alpha)
    G = mf.smith_g(wi, wo, h, alpha)
    F = fr.fresnel_dielectric(m.dot(wi, h), eta)[0]

    # reflection
    f_r = m.safe_div(D * G * F, 4.0 * torch.abs(cos_i))
    dwh_dwo_r = m.safe_div(torch.ones_like(D), 4.0 * torch.abs(m.dot(wo, h)))

    # refraction (Walter eq. 21)
    ih = m.dot(wi, h)
    oh = m.dot(wo, h)
    denom = ih + eta_it * oh
    jac = m.safe_div(eta_it * eta_it * torch.abs(oh), denom * denom)
    f_t = m.safe_div(
        torch.abs(ih * oh) * (1.0 - F) * D * G,
        torch.abs(cos_i) * denom * denom,
    ) * eta_it * eta_it
    # radiance scale factor 1/eta^2 for transmission (solid-angle compression)
    f_t = f_t / (eta_it * eta_it)

    f_val = torch.where(is_reflect, f_r, f_t)
    pdf = mf.pdf_ggx(h, alpha) * torch.where(is_reflect, F * dwh_dwo_r, (1.0 - F) * jac)
    valid = D > 0.0
    f3 = albedo * torch.where(valid, f_val, 0.0)[:, None]
    return f3, torch.where(valid, pdf, 0.0)


# ===========================================================================
# Public API
# ===========================================================================

def eval_pdf(mats, textures, si, wo, active=None):
    """(f, pdf) for direction wo given si (both local frame)."""
    present = _as_present(mats.kinds_present)
    row = _gather_rows(mats, si.mat_id)
    wi_f, wo_f, _ = _flip_frame(row, si.wi, wo)
    albedo = _albedo(row, textures, si.uv)
    f, pdf = _eval_pdf_kinds(row, albedo, wi_f, wo_f, present)
    if BSDFKind.MASK in present:
        # mask wrapper: scale by opacity
        op = _opacity(row, textures, si.uv)
        op_l = m.luminance(op)
        f = torch.where(row["is_mask"][:, None], f * op, f)
        pdf = torch.where(row["is_mask"], pdf * op_l, pdf)
    valid = si.mat_id >= 0
    if active is not None:
        valid = valid & active
    return torch.where(valid[:, None], f, 0.0), torch.where(valid, pdf, 0.0)


def sample(mats, textures, si, u1, u2, active=None):
    """Sample wo ~ BSDF; returns (BSDFSample, weight).  Candidates of kinds
    absent from the scene are not generated."""
    K = BSDFKind
    present = _as_present(mats.kinds_present)
    row = _gather_rows(mats, si.mat_id)
    wi, flip_sign = _flip_frame(row, si.wi)
    albedo = _albedo(row, textures, si.uv)
    n = wi.shape[0]
    cos_i = wi[..., 2]
    kind = row["kind"]
    eta_rel = torch.clamp(row["params"][:, 0], min=1e-3)
    alpha = torch.clamp(row["params"][:, 6], min=_MIN_ALPHA)
    ones = torch.ones_like(cos_i)
    false = torch.zeros_like(cos_i, dtype=torch.bool)
    wo_tab: dict = {}
    w_tab: dict = {}
    pdf_tab: dict = {}
    eta_tab: dict = {}
    refl_d = refl_rd = spec_pl = mask_pass = false
    op = torch.ones((n, 3), dtype=m.Float, device=wi.device)
    op_l = ones

    # --- mask pass-through lobe -------------------------------------------
    if K.MASK in present:
        op = _opacity(row, textures, si.uv)
        op_l = _clip(m.luminance(op), 1e-4, 1.0 - 1e-4)
        mask_pass = row["is_mask"] & (u1 >= op_l)
        # renormalize u1 within the kept branch
        u1 = torch.where(row["is_mask"], torch.clamp(m.safe_div(u1, op_l), 0.0, 1.0 - 1e-6), u1)

    # --- per-kind candidate samples ---------------------------------------
    # diffuse: cosine hemisphere (always traced: fallback default direction)
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_diff)
    w_diff = albedo  # f*cos/pdf = albedo
    wo_tab[K.DIFFUSE] = wo_diff
    w_tab[K.DIFFUSE] = w_diff
    pdf_tab[K.DIFFUSE] = pdf_diff

    # smooth conductor: mirror
    if K.CONDUCTOR in present:
        wo_tab[K.CONDUCTOR] = m.reflect(wi)
        F_c = fr.fresnel_conductor(cos_i, row["params"][:, 0:3], row["params"][:, 3:6])
        w_tab[K.CONDUCTOR] = albedo * F_c
        pdf_tab[K.CONDUCTOR] = ones

    # GGX half-vector (shared by rough conductor/plastic/principled/dielectric)
    if present & {K.ROUGH_CONDUCTOR, K.ROUGH_PLASTIC, K.PRINCIPLED, K.ROUGH_DIELECTRIC}:
        h, pdf_h = mf.sample_ggx(u2, alpha)
        wo_rc = m.reflect_about(wi, h)

    if K.ROUGH_CONDUCTOR in present:
        wo_tab[K.ROUGH_CONDUCTOR] = wo_rc
        pdf_tab[K.ROUGH_CONDUCTOR] = m.safe_div(pdf_h, 4.0 * torch.abs(m.dot(wo_rc, h)))
        G_rc = mf.smith_g(wi, wo_rc, h, alpha)
        F_rc = fr.fresnel_conductor(m.dot(wi, h), row["params"][:, 0:3], row["params"][:, 3:6])
        # weight = F * G * <wi,h> / (<wi,n> <h,n>)   (D cancels)
        w_rc = albedo * F_rc * m.safe_div(G_rc * m.dot(wi, h), cos_i * h[..., 2])[:, None]
        w_tab[K.ROUGH_CONDUCTOR] = torch.where((wo_rc[..., 2] * cos_i > 0.0)[:, None], w_rc, 0.0)

    # smooth dielectric: reflect/refract by Fresnel
    if K.DIELECTRIC in present:
        F_d, cos_t, eta_it, eta_ti = fr.fresnel_dielectric(cos_i, eta_rel)
        refl_d = u1 < F_d
        wo_tab[K.DIELECTRIC] = torch.where(
            refl_d[:, None], m.reflect(wi), m.refract(wi, cos_t, eta_ti)
        )
        w_tab[K.DIELECTRIC] = albedo * torch.where(
            refl_d, 1.0, eta_ti * eta_ti  # radiance scaling on refraction
        )[:, None]
        pdf_tab[K.DIELECTRIC] = torch.where(refl_d, F_d, 1.0 - F_d)
        eta_tab[K.DIELECTRIC] = torch.where(refl_d, 1.0, eta_it)

    # rough dielectric: GGX half-vector + fresnel choice
    if K.ROUGH_DIELECTRIC in present:
        F_h, cos_t_h, eta_it_h, eta_ti_h = fr.fresnel_dielectric(m.dot(wi, h), eta_rel)
        refl_rd = u1 < F_h
        wo_rd_r = m.reflect_about(wi, h)
        # refract about h: Snell in the h frame
        ih = m.dot(wi, h)
        c_abs = torch.abs(cos_t_h)
        wo_rd_t = m.normalize(
            (eta_ti_h * torch.abs(ih) - c_abs)[:, None] * h
            * m.sign_not_zero(ih)[:, None]
            - eta_ti_h[:, None] * wi
        )
        wo_rd = torch.where(refl_rd[:, None], wo_rd_r, wo_rd_t)
        # _rough_dielectric_eval_pdf returns f * |cos_o| (Mitsuba convention)
        f_rd3, pdf_rd = _rough_dielectric_eval_pdf(row, albedo, wi, wo_rd, eta_rel, alpha)
        wo_tab[K.ROUGH_DIELECTRIC] = wo_rd
        w_tab[K.ROUGH_DIELECTRIC] = m.safe_div(f_rd3, pdf_rd[:, None])
        pdf_tab[K.ROUGH_DIELECTRIC] = pdf_rd
        eta_tab[K.ROUGH_DIELECTRIC] = torch.where(refl_rd, 1.0, eta_it_h)

    # plastic (smooth): fresnel-weighted specular or diffuse
    if present & {K.PLASTIC, K.ROUGH_PLASTIC}:
        F_i = fr.fresnel_dielectric(cos_i, eta_rel)[0]
    if K.PLASTIC in present:
        spec_pl = u1 < F_i
        wo_pl = torch.where(spec_pl[:, None], m.reflect(wi), wo_diff)
        fdr_int = fr.fresnel_diffuse_reflectance(1.0 / eta_rel)
        inv_eta2 = 1.0 / (eta_rel * eta_rel)
        F_o_pl = fr.fresnel_dielectric(wo_pl[..., 2], eta_rel)[0]
        # diffuse weight = f*cos/pdf with pdf = (1-F_i) * cos/pi
        w_pl_diff = albedo * m.safe_div((1.0 - F_o_pl) * inv_eta2, 1.0 - fdr_int)[:, None]
        wo_tab[K.PLASTIC] = wo_pl
        w_tab[K.PLASTIC] = torch.where(spec_pl[:, None], torch.ones_like(albedo), w_pl_diff)
        pdf_tab[K.PLASTIC] = torch.where(spec_pl, F_i, (1.0 - F_i) * pdf_diff)

    # rough plastic: choose GGX spec vs diffuse
    if K.ROUGH_PLASTIC in present:
        prob_spec_rp = torch.clamp(F_i, 0.25, 0.75)
        spec_rp = u1 < prob_spec_rp
        wo_rp = torch.where(spec_rp[:, None], wo_rc, wo_diff)
        f_rp, pdf_rp = _eval_pdf_kinds(
            {**row, "kind": torch.full_like(kind, K.ROUGH_PLASTIC)},
            albedo, wi, wo_rp, {K.ROUGH_PLASTIC},
        )
        wo_tab[K.ROUGH_PLASTIC] = wo_rp
        w_tab[K.ROUGH_PLASTIC] = m.safe_div(f_rp, pdf_rp[:, None])
        pdf_tab[K.ROUGH_PLASTIC] = pdf_rp

    # principled: GGX spec vs cosine diffuse by metallic-weighted prob
    if K.PRINCIPLED in present:
        metallic = row["params"][:, 0]
        p_spec_prn = torch.clamp(0.25 + 0.5 * metallic, 0.25, 0.9)
        spec_prn = u1 < p_spec_prn
        wo_prn = torch.where(spec_prn[:, None], wo_rc, wo_diff)
        f_prn_s, pdf_prn_s = _eval_pdf_kinds(
            {**row, "kind": torch.full_like(kind, K.PRINCIPLED)},
            albedo, wi, wo_prn, {K.PRINCIPLED},
        )
        wo_tab[K.PRINCIPLED] = wo_prn
        w_tab[K.PRINCIPLED] = m.safe_div(f_prn_s, pdf_prn_s[:, None])
        pdf_tab[K.PRINCIPLED] = pdf_prn_s

    # null: straight through
    if K.NULL in present:
        wo_tab[K.NULL] = -wi
        w_tab[K.NULL] = torch.ones((n, 3), dtype=m.Float, device=wi.device)
        pdf_tab[K.NULL] = ones

    # --- select by kind ----------------------------------------------------
    wo = _select_kind(kind, wo_tab, wo_diff)
    weight = _select_kind(kind, w_tab, w_diff)
    pdf = _select_kind(kind, pdf_tab, pdf_diff)
    eta_out = _select_kind(kind, eta_tab, ones)
    delta_kinds = (
        (kind == K.CONDUCTOR)
        | (kind == K.DIELECTRIC)
        | ((kind == K.PLASTIC) & spec_pl)
        | (kind == K.NULL)
    )
    stype = torch.where(
        delta_kinds,
        torch.where(
            (kind == K.DIELECTRIC) & ~refl_d,
            BSDFFlags.DeltaTransmission,
            torch.where(kind == K.NULL, BSDFFlags.Null, BSDFFlags.DeltaReflection),
        ),
        torch.where(
            kind == K.DIFFUSE,
            BSDFFlags.DiffuseReflection,
            torch.where(
                (kind == K.ROUGH_DIELECTRIC) & ~refl_rd,
                BSDFFlags.GlossyTransmission,
                BSDFFlags.GlossyReflection,
            ),
        ),
    ).to(torch.int32)

    # --- mask wrapper: pass-through overrides ------------------------------
    if K.MASK in present:
        weight = torch.where(
            row["is_mask"][:, None],
            torch.where(
                mask_pass[:, None],
                m.safe_div(1.0 - op, (1.0 - op_l)[:, None]),
                weight * m.safe_div(op, op_l[:, None]),
            ),
            weight,
        )
        wo = torch.where(mask_pass[:, None], -wi, wo)
        pdf = torch.where(mask_pass, 1.0 - op_l, torch.where(row["is_mask"], pdf * op_l, pdf))
        stype = torch.where(mask_pass, BSDFFlags.Null, stype).to(torch.int32)
        eta_out = torch.where(mask_pass, 1.0, eta_out)

    # --- validity ----------------------------------------------------------
    valid = si.mat_id >= 0
    if active is not None:
        valid = valid & active
    # one-sided materials: no response from the back
    transmissive = (kind == K.DIELECTRIC) | (kind == K.ROUGH_DIELECTRIC) | (kind == K.NULL)
    front_ok = (cos_i > 0.0) | transmissive | mask_pass
    # hemisphere check: a GGX-sampled half-vector can reflect wo below the
    # surface — such samples are invalid (pdf -> 0)
    same_side = wo[..., 2] * cos_i > 0.0
    hemi_ok = torch.where(
        transmissive,
        torch.where(
            kind == K.ROUGH_DIELECTRIC,
            torch.where(refl_rd, same_side, wo[..., 2] * cos_i < 0.0),
            True,
        ),
        same_side,
    )
    hemi_ok = hemi_ok | mask_pass
    valid = valid & front_ok & hemi_ok & (pdf > 0.0)

    weight = torch.where(valid[:, None], weight, 0.0)
    # jnp.maximum's gradient: half where the weight is 0 (a zero albedo channel)
    weight = torch.maximum(weight, weight.new_zeros(()))

    # un-flip wo back to the true frame
    wo = _with_z(wo, wo[..., 2] * flip_sign)

    bs = BSDFSample(
        wo=wo,
        pdf=torch.where(valid, pdf, 0.0),
        eta=eta_out,
        sampled_type=torch.where(valid, stype, 0).to(torch.int32),
    )
    return bs, weight


def eval_pdf_sample(mats, textures, si, wo_query, u1, u2, active=None):
    """Fused eval_pdf + sample (bsdf.eval_pdf_sample)."""
    f, pdf = eval_pdf(mats, textures, si, wo_query, active)
    bs, weight = sample(mats, textures, si, u1, u2, active)
    return f, pdf, bs, weight
