"""Surface BSDFs on interpolated vertex attributes (volprim_tpu.ops.bsdf).

The Principled BRDF restricted to its reflection lobes (GGX specular
reflection and the diffuse / retro-reflection lobe; no transmission,
clearcoat or sheen) and a Lambertian ``Diffuse``, with material parameters
given per shading point as a dict of tensors, as barycentric interpolation
of a mesh's vertex attributes gives them.

Directions are in the local shading frame (z = shading normal), pointing
away from the surface: ``wi`` toward the viewer, ``wo`` the queried or
sampled direction. ``eval`` returns the BSDF value times |cos theta_o|;
``sample`` returns (wo, pdf, weight = eval / pdf) on uniforms the caller
draws: s1 [...] (the Principled model's lobe choice; Diffuse ignores it)
and s2 [..., 2] (the direction).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

_INV_PI = 1.0 / math.pi


def _dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


def make_frame(n: torch.Tensor):
    """Branchless orthonormal basis around n [..., 3]. Returns (t, b, n)."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, bt, n


def to_local(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    t, b, nn = make_frame(n)
    return torch.stack([_dot(v, t), _dot(v, b), _dot(v, nn)], dim=-1)


def to_world(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    t, b, nn = make_frame(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * nn


# ---------------------------------------------------------------------------
# Fresnel / Schlick
# ---------------------------------------------------------------------------


def fresnel_dielectric(cos_theta_i: torch.Tensor, eta: float) -> torch.Tensor:
    """Unpolarized dielectric Fresnel reflectance."""
    outside = cos_theta_i >= 0.0
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    ci = torch.abs(cos_theta_i)
    ct2 = 1.0 - (1.0 - ci * ci) * eta_ti * eta_ti
    tir = ct2 <= 0.0
    ct = torch.sqrt(torch.clamp(ct2, min=0.0))
    e_it = torch.where(outside, eta, 1.0 / eta)
    r_s = (ci - e_it * ct) / torch.clamp(ci + e_it * ct, min=1e-12)
    r_p = (e_it * ci - ct) / torch.clamp(e_it * ci + ct, min=1e-12)
    f = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, f)


def schlick_r0_eta(eta):
    return ((eta - 1.0) / (eta + 1.0)) ** 2


def schlick_weight(cos_i: torch.Tensor) -> torch.Tensor:
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return (m * m) ** 2 * m


def calc_schlick(r0, cos_theta_i: torch.Tensor, eta: float):
    """Schlick's approximation with the refraction-side branch."""
    outside = cos_theta_i >= 0.0
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    ct2 = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * eta_ti * eta_ti
    ct = torch.sqrt(torch.clamp(ct2, min=0.0))
    w = schlick_weight(torch.abs(cos_theta_i)) if eta > 1.0 else schlick_weight(ct)
    if torch.is_tensor(r0) and r0.dim() and r0.shape[-1] == 3 and w.dim() < r0.dim():
        w = w[..., None]
    return r0 + (1.0 - r0) * w


def principled_fresnel(f_dielectric, metallic, spec_tint, base_color, lum, cos_theta_i,
                       front_side, eta: float, has_metallic: bool, has_spec_tint: bool):
    """The Principled BRDF's Fresnel term, transmission weight 0."""
    f_schlick = torch.zeros_like(base_color)
    if has_metallic:
        f_schlick = f_schlick + metallic[..., None] * calc_schlick(base_color, cos_theta_i, eta)
    if has_spec_tint:
        c_tint = torch.where(lum[..., None] > 0.0,
                             base_color / torch.clamp(lum[..., None], min=1e-12), 1.0)
        outside = cos_theta_i >= 0.0
        eta_it = torch.where(outside, eta, 1.0 / eta)
        f0 = c_tint * schlick_r0_eta(eta_it)[..., None]
        f_schlick = f_schlick + (1.0 - metallic[..., None]) * spec_tint[..., None] * calc_schlick(
            f0, cos_theta_i, eta)
    f_front = ((1.0 - metallic[..., None]) * (1.0 - spec_tint[..., None])
               * f_dielectric[..., None] + f_schlick)
    return torch.where(front_side[..., None], f_front, 0.0)


# ---------------------------------------------------------------------------
# GGX microfacet distribution (anisotropic, visible-normal sampling)
# ---------------------------------------------------------------------------


def _dist_params(anisotropic, roughness, has_anisotropic: bool):
    r2 = roughness * roughness
    if not has_anisotropic:
        a = torch.clamp(r2, min=0.001)
        return a, a
    aspect = torch.sqrt(1.0 - 0.9 * anisotropic)
    return torch.clamp(r2 / aspect, min=0.001), torch.clamp(r2 * aspect, min=0.001)


def ggx_d(m: torch.Tensor, ax, ay) -> torch.Tensor:
    s = (m[..., 0] / ax) ** 2 + (m[..., 1] / ay) ** 2 + m[..., 2] ** 2
    return torch.where(m[..., 2] > 0.0, _INV_PI / (ax * ay * torch.clamp(s * s, min=1e-20)), 0.0)


def ggx_g1(v: torch.Tensor, ax, ay) -> torch.Tensor:
    xy = (ax * v[..., 0]) ** 2 + (ay * v[..., 1]) ** 2
    z2 = v[..., 2] ** 2
    return 2.0 / (1.0 + torch.sqrt(1.0 + xy / torch.clamp(z2, min=1e-20)))


def ggx_sample_vndf(wi: torch.Tensor, ax, ay, sample2: torch.Tensor) -> torch.Tensor:
    """Visible-normal sampling of the GGX distribution (Heitz 2018)."""
    v = _normalize(torch.stack([ax * wi[..., 0], ay * wi[..., 1], wi[..., 2]], dim=-1))
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 1e-20)[..., None],
        torch.stack([-v[..., 1] * inv, v[..., 0] * inv, torch.zeros_like(inv)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device).expand(v.shape),
    )
    t2 = torch.linalg.cross(v, t1)
    r = torch.sqrt(sample2[..., 0])
    phi = 2.0 * math.pi * sample2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    m = torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return _normalize(m)


def ggx_pdf_visible(wi: torch.Tensor, m: torch.Tensor, ax, ay) -> torch.Tensor:
    """pdf of m under visible-normal sampling from wi (local, wi.z > 0)."""
    return (ggx_g1(wi, ax, ay) * ggx_d(m, ax, ay) * torch.abs(_dot(wi, m))
            / torch.clamp(torch.abs(wi[..., 2]), min=1e-12))


def _mac_mic_compat(m, wi, wo, cos_theta_i):
    ms = m * torch.sign(cos_theta_i)[..., None]
    return (_dot(wi, ms) > 0.0) & (_dot(wo, ms) > 0.0)


def _mulsign(v, s):
    return v * torch.sign(torch.where(s == 0.0, 1.0, s))[..., None]


def _half_vector(wi, wo):
    wh = _normalize(wi + wo)  # reflection only: the eta factor is 1
    return _mulsign(wh, wh[..., 2])


# ---------------------------------------------------------------------------
# Principled BRDF (reflection lobes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Principled:
    """Reflection-only Principled BRDF over per-point attribute dicts:
    'base_color' [..., 3], 'roughness' [...], and 'metallic',
    'anisotropic', 'spec_tint' [...] when the matching flag is set."""

    has_metallic: bool = True
    has_anisotropic: bool = False
    has_spec_tint: bool = False
    specular: float = 0.5

    @property
    def eta(self) -> float:
        return 2.0 / (1.0 - (0.08 * self.specular) ** 0.5) - 1.0

    def attr_names(self):
        """Vertex-attribute names this model interpolates."""
        names = ["base_color", "roughness"]
        if self.has_metallic:
            names.append("metallic")
        if self.has_anisotropic:
            names.append("anisotropic")
        if self.has_spec_tint:
            names.append("spec_tint")
        return names

    def _params(self, attrs: Dict[str, torch.Tensor]):
        rough = attrs["roughness"]
        metal = attrs["metallic"] if self.has_metallic else torch.zeros_like(rough)
        aniso = attrs["anisotropic"] if self.has_anisotropic else torch.zeros_like(rough)
        tint = attrs["spec_tint"] if self.has_spec_tint else torch.zeros_like(rough)
        return attrs["base_color"], rough, metal, aniso, tint

    def eval(self, attrs, wi, wo, active=True):
        """f(wi, wo) |cos theta_o|."""
        base, rough, metal, aniso, tint = self._params(attrs)
        eta = self.eta
        cti, cto = wi[..., 2], wo[..., 2]
        active = (cti != 0.0) & active
        reflect = cti * cto > 0.0
        front = cti > 0.0
        brdf = 1.0 - metal
        ax, ay = _dist_params(aniso, rough, self.has_anisotropic)
        wh = _half_vector(wi, wo)
        f_diel = fresnel_dielectric(_dot(wi, wh), eta)
        compat = _mac_mic_compat(wh, wi, wo, cti)
        spec_act = active & reflect & compat & (f_diel > 0.0)
        diff_act = active & (brdf > 0.0) & reflect & front
        d = ggx_d(wh, ax, ay)
        g = ggx_g1(wi, ax, ay) * ggx_g1(wo, ax, ay)
        lum = (0.2126 * base[..., 0] + 0.7152 * base[..., 1] + 0.0722 * base[..., 2]
               if self.has_spec_tint else torch.ones_like(rough))
        f_pr = principled_fresnel(f_diel, metal, tint, base, lum, _dot(wi, wh), front, eta,
                                  self.has_metallic, self.has_spec_tint)
        value = torch.where(
            spec_act[..., None],
            f_pr * (d * g / (4.0 * torch.clamp(torch.abs(cti), min=1e-12)))[..., None], 0.0)
        fo = schlick_weight(torch.abs(cto))
        fi = schlick_weight(torch.abs(cti))
        f_diff = (1.0 - 0.5 * fi) * (1.0 - 0.5 * fo)
        ctd = _dot(wh, wo)
        rr = 2.0 * rough * ctd * ctd
        f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
        value = value + torch.where(
            diff_act[..., None],
            (brdf * torch.abs(cto) * _INV_PI * (f_diff + f_retro))[..., None] * base, 0.0)
        return torch.where(active[..., None], value, 0.0)

    def pdf(self, attrs, wi, wo, active=True):
        base, rough, metal, aniso, tint = self._params(attrs)
        cti, cto = wi[..., 2], wo[..., 2]
        active = (cti != 0.0) & active
        front = cti > 0.0
        reflect = cti * cto > 0.0
        brdf = 1.0 - metal
        wh = _half_vector(wi, wo)
        ax, ay = _dist_params(aniso, rough, self.has_anisotropic)
        f_diel = fresnel_dielectric(_dot(wi, wh), self.eta)
        prob_spec = torch.where(front, 1.0, f_diel)
        prob_diff = torch.where(front, brdf, 0.0)
        rcp = 1.0 / torch.clamp(prob_spec + prob_diff, min=1e-12)
        prob_spec, prob_diff = prob_spec * rcp, prob_diff * rcp
        dwh_dwo = torch.abs(1.0 / torch.clamp(4.0 * torch.abs(_dot(wo, wh)), min=1e-12))
        compat = _mac_mic_compat(wh, wi, wo, cti) & reflect
        pdf = torch.where(
            compat, prob_spec * ggx_pdf_visible(_mulsign(wi, cti), wh, ax, ay) * dwh_dwo, 0.0)
        pdf = pdf + torch.where(reflect, prob_diff * torch.abs(cto) * _INV_PI, 0.0)
        return torch.where(active, pdf, 0.0)

    def sample(self, attrs, wi, s1, s2, active=True):
        """Returns (wo, pdf, weight = eval / pdf) on uniforms s1 [...] (lobe
        choice) and s2 [..., 2] (the direction; both lobes use it)."""
        base, rough, metal, aniso, tint = self._params(attrs)
        cti = wi[..., 2]
        active = (cti > 0.0) & active  # reflection only: the front side
        ax, ay = _dist_params(aniso, rough, self.has_anisotropic)
        m = ggx_sample_vndf(_mulsign(wi, cti), ax, ay, s2)
        brdf = 1.0 - metal
        prob_spec = torch.ones_like(cti)
        prob_diff = torch.where(cti > 0.0, brdf, 0.0)
        prob_diff = prob_diff / torch.clamp(prob_spec + prob_diff, min=1e-12)
        pick_diff = active & (s1 < prob_diff)
        wo_spec = 2.0 * _dot(wi, m, keepdim=True) * m - wi
        z = torch.sqrt(torch.clamp(1.0 - s2[..., 0], min=0.0))
        r = torch.sqrt(s2[..., 0])
        phi = 2.0 * math.pi * s2[..., 1]
        wo_diff = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
        wo = torch.where(pick_diff[..., None], wo_diff, wo_spec)
        reflect = cti * wo[..., 2] > 0.0
        ok_spec = _mac_mic_compat(m, wi, wo, cti) & reflect
        active = active & torch.where(pick_diff, reflect, ok_spec)
        pdf = self.pdf(attrs, wi, wo, active)
        active = active & (pdf > 0.0)
        val = self.eval(attrs, wi, wo, active)
        w = torch.where(active[..., None], val / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
        return wo, torch.where(active, pdf, 0.0), w


@dataclasses.dataclass(frozen=True)
class Diffuse:
    """Lambertian with per-point 'base_color'."""

    def attr_names(self):
        return ["base_color"]

    def eval(self, attrs, wi, wo, active=True):
        act = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & active
        val = attrs["base_color"] * (_INV_PI * wo[..., 2])[..., None]
        return torch.where(act[..., None], val, 0.0)

    def pdf(self, attrs, wi, wo, active=True):
        pdf = torch.abs(wo[..., 2]) * _INV_PI
        return torch.where((wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & active, pdf, 0.0)

    def sample(self, attrs, wi, s1, s2, active=True):
        """Returns (wo, pdf, weight) on uniforms s2 [..., 2] (s1 is unused)."""
        act = (wi[..., 2] > 0.0) & active
        z = torch.sqrt(torch.clamp(1.0 - s2[..., 0], min=0.0))
        r = torch.sqrt(s2[..., 0])
        phi = 2.0 * math.pi * s2[..., 1]
        wo = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
        pdf = torch.where(act, torch.abs(wo[..., 2]) * _INV_PI, 0.0)
        w = torch.where(act[..., None], attrs["base_color"], 0.0)
        return wo, pdf, w
