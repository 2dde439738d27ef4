"""Operations of one tomography step, from the configuration's shapes.

Every ray of the batch sensor meets every primitive: pairs = rays x
primitives (the padding to 1,024-wide chunks is the program's own).

- ``OPS_TOMO_PAIR`` (the port's chip_smoke.py): f32 operations per pair of
  the forward: the local frame's w and p 45, a and t* 12, q_min 11, the
  extent test 11, the integral and its scrub 9, the weighted sum 2.
- ``OPS_TOMO_PAIR_BWD`` (derived here): the backward needs each pair's
  intermediates again, which the forward's 88 operations before its sum
  recompute (storing them would move some 40 bytes a pair, more time than
  recomputing), then the adjoints: the density's g_q, g_a and g_s 7, the
  weighted sum's g_dens and g_sigma 3, q_min's g_p, g_w and g_t* 15, t*'s
  12, a's 6, w's g_rot and g_inv_s 24, p's g_center, g_rot and g_inv_s 30,
  and 13 sums over the rays into each primitive's adjoints: 110. So 198.

Bytes are each ray's origin and direction and each primitive's 14 floats
once, and the image once: a few MB, far below the operations' time.
"""

from . import least_time

OPS_TOMO_PAIR = 90
OPS_TOMO_PAIR_BWD = 88 + 110


def step_bound(rays: int, prims: int) -> dict:
    pairs = rays * prims
    nbytes = rays * 6 * 4 + prims * 14 * 4 + rays * 3 * 4
    out = least_time(pairs * (OPS_TOMO_PAIR + OPS_TOMO_PAIR_BWD), nbytes)
    out["pairs"] = pairs
    return out
