"""Vmapped rigid-body dynamics in pure JAX.

JAX replacement for the reference's PyBullet drop simulation
(reference: src/engine/physical_simulation.py:98-170): drop rigid objects
onto a ground-aligned environment, record per-step poses.  The reference
steps Bullet's C++ LCP solver one scene at a time on the CPU; here the
stepper is a pure function of static-shaped arrays, so `vmap` simulates
hundreds of scene variants in parallel and `jax.sharding` spreads them
over a device mesh.

Model
-----
* bodies: environment (body 0, static, infinite mass) + K dynamic objects,
  matching Bullet body ids in the trajectory JSON;
* collision geometry: per-body point cloud (hull vertices of the URDF
  collision mesh) against the environment ground plane z=0 — PEGASUS
  environments are plane-aligned by construction (align2plane,
  SURVEY 2.3.3) — plus point-vs-hull and edge-vs-edge contacts between
  objects (the two feature classes of a convex manifold);
* contacts: impulse-based with Baumgarte positional bias, Coulomb
  friction, Jacobi iterations (impulses split across active points);
* integrator: semi-implicit Euler, quaternion kinematics
  q' = q + dt/2 * omega (x) q, dt = 1 ms and gravity (0,0,-50) by default —
  the reference's settings (physical_simulation.py:47,115-116).

Parity target is REST POSES within tolerance, not Bullet step-for-step
equality (BASELINE.md).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.lax import Precision

from pegasus_tpu.physics.heightfield import Heightfield, height_at, normal_at
from pegasus_tpu.utils import pytree
from pegasus_tpu.utils import quaternion as quat

# every contraction in float32: a GPU otherwise runs float32 products in
# TF32, and 310 steps of contact resolution turn that into different rest
# poses (centimetres and tens of degrees apart from the same drop on the
# CPU); at HIGHEST the two agree to micrometres
_einsum = partial(jnp.einsum, precision=Precision.HIGHEST)

DEFAULT_GRAVITY = (0.0, 0.0, -50.0)
DEFAULT_DT = 1.0 / 1000.0


@pytree.dataclass
class RigidBodyState:
    pos: jnp.ndarray  # [B, 3] world position of body origin
    rot: jnp.ndarray  # [B, 4] wxyz orientation
    linvel: jnp.ndarray  # [B, 3]
    angvel: jnp.ndarray  # [B, 3] world frame

    @classmethod
    def rest(cls, pos, rot) -> "RigidBodyState":
        pos = jnp.asarray(pos, jnp.float32)
        return cls(
            pos=pos,
            rot=quat.normalize(jnp.asarray(rot, jnp.float32)),
            linvel=jnp.zeros_like(pos),
            angvel=jnp.zeros_like(pos),
        )


@pytree.dataclass
class RigidBodyParams:
    inv_mass: jnp.ndarray  # [B] 0 for static bodies (environment)
    inv_inertia: jnp.ndarray  # [B, 3] inverse principal inertia (body frame)
    points: jnp.ndarray  # [B, P, 3] collision points in body frame
    point_mask: jnp.ndarray  # [B, P] bool
    radius: jnp.ndarray  # [B] bounding-sphere radius (pair broad phase)
    friction: jnp.ndarray  # [B]
    restitution: jnp.ndarray  # [B]
    body_mask: jnp.ndarray  # [B] bool: body exists (padding support)
    half_extents: jnp.ndarray = None  # [B, 3] box fallback for hull planes
    plane_n: jnp.ndarray = None  # [B, H, 3] convex-hull facet normals (body)
    plane_d: jnp.ndarray = None  # [B, H] facet offsets: inside iff n.x <= d
    plane_group: jnp.ndarray = None  # [B, H] i32 hull part id (multi-hull
    # approximate convex decomposition; padding planes carry d=1e9)
    edge_a: jnp.ndarray = None  # [B, E, 3] hull edge start points (body frame)
    edge_b: jnp.ndarray = None  # [B, E, 3] hull edge end points
    edge_mask: jnp.ndarray = None  # [B, E] bool
    num_hull_parts: int = pytree.field(pytree_node=False, default=1)

    def __post_init__(self):
        if self.half_extents is None:
            # fall back to a cube from the bounding sphere
            object.__setattr__(
                self,
                "half_extents",
                jnp.broadcast_to(
                    (self.radius / jnp.sqrt(3.0))[:, None],
                    self.radius.shape + (3,),
                ),
            )
        if self.plane_n is None:
            # box half-space set from half_extents (6 axis-aligned facets) —
            # the general pair narrow phase is point-vs-convex-hull; a box
            # is just the 6-plane special case (Bullet's loadURDF similarly
            # collides the convex hull of the URDF mesh)
            he = jnp.asarray(self.half_extents, jnp.float32)
            eye = jnp.eye(3, dtype=jnp.float32)
            n = jnp.concatenate([eye, -eye], axis=0)  # [6, 3]
            b = he.shape[0]
            object.__setattr__(
                self, "plane_n", jnp.broadcast_to(n[None], (b, 6, 3))
            )
            object.__setattr__(
                self,
                "plane_d",
                jnp.concatenate([he, he], axis=-1),  # [B, 6]
            )
        if self.plane_group is None:
            object.__setattr__(
                self,
                "plane_group",
                jnp.zeros(self.plane_d.shape, jnp.int32),
            )
        if self.edge_a is None:
            # the 12 box edges from half_extents (engine.py passes real
            # hull edges for mesh bodies; this is the box fallback)
            he = jnp.asarray(self.half_extents, jnp.float32)  # [B, 3]
            corners = jnp.stack(
                [
                    jnp.array([sx, sy, sz], jnp.float32)
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
                ]
            )  # [8, 3] sign patterns
            # 12 edges as (corner index, corner index) differing in one axis
            pairs = jnp.array(
                [
                    (a, c)
                    for a in range(8)
                    for c in range(a + 1, 8)
                    if bin(a ^ c).count("1") == 1
                ],
                jnp.int32,
            )  # [12, 2]
            ca = corners[pairs[:, 0]]  # [12, 3]
            cb = corners[pairs[:, 1]]
            object.__setattr__(
                self, "edge_a", he[:, None, :] * ca[None, :, :]
            )
            object.__setattr__(
                self, "edge_b", he[:, None, :] * cb[None, :, :]
            )
        if self.edge_mask is None:
            object.__setattr__(
                self,
                "edge_mask",
                jnp.broadcast_to(
                    self.body_mask[:, None], self.edge_a.shape[:2]
                ),
            )


def _world_points(state: RigidBodyState, params: RigidBodyParams):
    """[B, P, 3] collision points in world frame and their lever arms."""
    R = quat.quat_to_rotmat(state.rot)  # [B, 3, 3]
    arms = _einsum("bij,bpj->bpi", R, params.points)  # r_i in world
    return state.pos[:, None, :] + arms, arms


def _ground_contacts(
    state: RigidBodyState,
    params: RigidBodyParams,
    hf: Heightfield,
    dt: float,
    baumgarte: float,
    slop: float,
):
    """Impulse pass for point-vs-environment contacts (one Jacobi sweep).

    The environment is a baked heightfield (plane by default); contact
    normal and penetration come from bilinear lookups, so the whole pass
    stays elementwise (physics/heightfield.py).  Returns (dv, dw)
    world-frame velocity corrections per body.
    """
    x, r = _world_points(state, params)  # [B, P, 3]
    ground = height_at(hf, x[..., 0], x[..., 1])
    pen = ground - x[..., 2]  # penetration depth (>0 below the surface)
    active = (pen > 0.0) & params.point_mask & (params.inv_mass > 0)[:, None]
    n_active = jnp.maximum(jnp.sum(active, axis=1, keepdims=True), 1)

    R = quat.quat_to_rotmat(state.rot)
    inv_I_world = _einsum(
        "bij,bj,bkj->bik", R, params.inv_inertia, R
    )  # R diag(I^-1) R^T

    # velocity of each contact point
    u = state.linvel[:, None, :] + jnp.cross(state.angvel[:, None, :], r)

    n = normal_at(hf, x[..., 0], x[..., 1])  # [B, P, 3]
    u_n = jnp.sum(u * n, axis=-1)

    # effective mass along the normal at each point
    rxn = jnp.cross(r, n)  # [B, P, 3]
    ang_term = _einsum(
        "bpi,bij,bpj->bp", rxn, inv_I_world, rxn
    )
    m_eff_inv = params.inv_mass[:, None] + ang_term
    m_eff = 1.0 / jnp.maximum(m_eff_inv, 1e-9)

    # normal impulse toward a TARGET separation velocity: the larger of
    # the Baumgarte bias and the restitution bounce.  Driving u_n *to*
    # the target (rather than adding the bias unconditionally) stops the
    # solver iterations from pumping velocity into resting contacts.
    bias = (baumgarte / dt) * jnp.maximum(pen - slop, 0.0)
    e = params.restitution[:, None]
    target = jnp.maximum(-e * jnp.minimum(u_n, 0.0), bias)
    jn = jnp.where(active, m_eff * jnp.maximum(target - u_n, 0.0), 0.0)

    # friction impulse: oppose tangential velocity, clamped by mu * jn
    u_t = u - u_n[..., None] * n
    u_t_norm = jnp.linalg.norm(u_t, axis=-1)
    t_hat = u_t / jnp.maximum(u_t_norm, 1e-9)[..., None]
    rxt = jnp.cross(r, t_hat)
    ang_term_t = _einsum("bpi,bij,bpj->bp", rxt, inv_I_world, rxt)
    m_eff_t = 1.0 / jnp.maximum(params.inv_mass[:, None] + ang_term_t, 1e-9)
    jt = jnp.minimum(m_eff_t * u_t_norm, params.friction[:, None] * jn)
    jt = jnp.where(active, jt, 0.0)

    # total impulse per point, split across simultaneous contacts (Jacobi)
    imp = (jn[..., None] * n - jt[..., None] * t_hat) / n_active[..., None]
    imp = jnp.where(active[..., None], imp, 0.0)

    dv = params.inv_mass[:, None] * jnp.sum(imp, axis=1)
    dw = _einsum(
        "bij,bj->bi", inv_I_world, jnp.sum(jnp.cross(r, imp), axis=1)
    )
    return dv, dw


def _hull_union_reduce(facet_pen, group, real, n_groups):
    """Decomposed-hull membership reduce shared by the point and edge
    narrow phases: per hull part, the min facet distance (signed; > 0
    means inside that part's margin shell); the DEEPEST part wins.
    `group`/`real` broadcast against facet_pen's last (facet) axis.
    Returns (depth [...], h_star [...]) — h_star is the binding facet
    index within the winning part (meaningful only where depth > 0)."""
    depth = jnp.full(facet_pen.shape[:-1], -jnp.inf)
    h_star = jnp.zeros(facet_pen.shape[:-1], jnp.int32)
    for g in range(n_groups):
        in_g = group == g
        pen_g = jnp.where(in_g, facet_pen, jnp.inf)
        depth_g = jnp.min(pen_g, axis=-1)
        h_g = jnp.argmin(pen_g, axis=-1)
        exists_g = jnp.any(in_g & real, axis=-1)
        valid_g = jnp.isfinite(depth_g) & exists_g
        better = valid_g & (depth_g > depth)
        depth = jnp.where(better, depth_g, depth)
        h_star = jnp.where(better, h_g, h_star)
    return depth, h_star


def _pair_contacts(
    state: RigidBodyState,
    params: RigidBodyParams,
    dt: float,
    baumgarte: float,
    margin: float = 4e-3,
):
    """Object-object contacts: body i's collision points vs body j's
    convex hull (half-space set).

    Point-vs-hull narrow phase (bounding spheres gate the pairs): each of
    i's contact points is tested against j's hull planes; penetration is
    the minimum facet distance and the contact normal is that facet's
    world normal.  Boxes are the 6-plane special case; URDF meshes carry
    their real hull facets, so concave-ish objects (bowl, pitcher, drill)
    rest against their hull like Bullet's loadURDF convex collision
    (reference: physical_simulation.py:77).  Impulses (normal + Baumgarte
    bias) apply equal-and-opposite to both bodies with full angular terms.

    Returns (dv [B,3], dw [B,3]).
    """
    b = state.pos.shape[0]
    x, r_arm = _world_points(state, params)  # [B, P, 3] of OWNER i
    R = quat.quat_to_rotmat(state.rot)  # [B, 3, 3]
    inv_I_world = _einsum("bij,bj,bkj->bik", R, params.inv_inertia, R)

    # broad phase
    diff = state.pos[:, None, :] - state.pos[None, :, :]
    dist = jnp.linalg.norm(diff + jnp.eye(b)[..., None], axis=-1)
    rsum = params.radius[:, None] + params.radius[None, :]
    dynamic = (params.inv_mass > 0) & params.body_mask
    pair_ok = (
        dynamic[:, None] & dynamic[None, :] & ~jnp.eye(b, dtype=bool)
        & (dist < rsum)
    )  # [B(i), B(j)]

    # i's points in j's local frame: [B_i, B_j, P, 3]
    rel = x[:, None, :, :] - state.pos[None, :, None, :]
    p_local = _einsum("jab,ijpa->ijpb", R, rel)  # R_j^T @ rel
    # signed distance to each hull facet of j, with a margin shell
    # (Bullet keeps a similar shell) so exactly-touching faces resolve.
    # j's collision shape is a UNION of convex parts (plane_group ids —
    # approximate convex decomposition, beyond Bullet's default
    # single-hull loadURDF): a point collides a part iff n_h . p <=
    # d_h + margin for ALL of that part's facets; among penetrated parts
    # the deepest one supplies depth and normal.
    facet_pen = (
        (params.plane_d + margin)[None, :, None, :]
        - _einsum("jha,ijpa->ijph", params.plane_n, p_local)
    )  # [B_i, B_j, P, H]
    depth, h_star = _hull_union_reduce(
        facet_pen,
        params.plane_group[None, :, None, :],
        (params.plane_d < 1e8)[None, :, None, :],
        params.num_hull_parts,
    )

    inside = (depth > 0.0) & pair_ok[:, :, None]
    inside = inside & params.point_mask[:, None, :]
    depth = jnp.where(inside, depth, 0.0)
    n_local = jnp.take_along_axis(
        jnp.broadcast_to(
            params.plane_n[None, :, None, :, :],
            facet_pen.shape + (3,),
        ),
        h_star[..., None, None].repeat(3, -1),
        axis=-2,
    )[..., 0, :]  # [B_i, B_j, P, 3] outward facet normal in j's frame
    # world normal points from j toward i (outward from j's hull part)
    n = _einsum("jab,ijpb->ijpa", R, n_local)

    # contact-point velocities
    r_i = r_arm[:, None, :, :]  # arm on i
    r_j = x[:, None, :, :] - state.pos[None, :, None, :]  # arm on j
    u = (
        state.linvel[:, None, None, :]
        + jnp.cross(state.angvel[:, None, None, :], r_i)
        - state.linvel[None, :, None, :]
        - jnp.cross(state.angvel[None, :, None, :], r_j)
    )
    u_n = jnp.sum(u * n, axis=-1)  # [B_i, B_j, P]

    # effective mass with angular terms on both bodies
    rxn_i = jnp.cross(r_i, n)
    rxn_j = jnp.cross(r_j, n)
    ang_i = _einsum("ijpa,iab,ijpb->ijp", rxn_i, inv_I_world, rxn_i)
    ang_j = _einsum("ijpa,jab,ijpb->ijp", rxn_j, inv_I_world, rxn_j)
    m_eff = 1.0 / jnp.maximum(
        params.inv_mass[:, None, None] + params.inv_mass[None, :, None]
        + ang_i + ang_j,
        1e-9,
    )

    # positional bias only for penetration beyond the margin shell;
    # capped so deeply-overlapping spawns separate gently instead of
    # being launched (Bullet similarly caps penetration recovery).  The
    # bias is a TARGET separation velocity (see _ground_contacts).
    bias = jnp.minimum((baumgarte / dt) * jnp.maximum(depth - margin, 0.0), 1.0)
    jn = m_eff * jnp.maximum(bias - u_n, 0.0)
    # Jacobi split PER PAIR with over-relaxation: contacts of one pair
    # share (roughly) a direction, so dividing by the pair's count and
    # relaxing toward full correction converges in few sweeps without the
    # dilution a global per-body split causes
    n_pair = jnp.maximum(jnp.sum(inside, axis=2, keepdims=True), 1)
    jn = 1.6 * jnp.where(inside, jn, 0.0) / n_pair

    # Coulomb friction against the tangential slip at each contact
    u_t = u - u_n[..., None] * n
    u_t_norm = jnp.linalg.norm(u_t, axis=-1)
    t_hat = u_t / jnp.maximum(u_t_norm, 1e-9)[..., None]
    mu = jnp.minimum(params.friction[:, None], params.friction[None, :])[
        ..., None
    ]
    jt = jnp.minimum(m_eff * u_t_norm / jnp.maximum(n_pair, 1), mu * jn)
    jt = jnp.where(inside, jt, 0.0)

    imp = jn[..., None] * n - jt[..., None] * t_hat  # on body i (+), j (-)
    dv = params.inv_mass[:, None] * jnp.sum(imp, axis=(1, 2)) - (
        params.inv_mass[:, None]
        * jnp.sum(jnp.swapaxes(imp, 0, 1), axis=(1, 2))
    )
    torque_i = jnp.sum(jnp.cross(r_i, imp), axis=(1, 2))
    # reaction torque on body j accumulates over the other index
    torque_j = -jnp.sum(jnp.swapaxes(jnp.cross(r_j, imp), 0, 1), axis=(1, 2))
    dw = _einsum("bij,bj->bi", inv_I_world, torque_i + torque_j)
    return dv, dw


def _edge_manifold(
    state: RigidBodyState,
    params: RigidBodyParams,
    margin: float = 4e-3,
    shell: float = 4e-2,
):
    """Edge-edge narrow phase: the contact case point-vs-hull misses.

    Two hulls can interpenetrate with NO vertex of either inside the
    other (e.g. two thin boxes crossing like an X) — Bullet's persistent
    manifolds catch this via GJK/EPA edge-edge features
    (reference: physical_simulation.py:126 steps the LCP solver over
    them).  Here, for every dynamic pair (i < j) and every hull-edge
    pair: closest points between the two segments (branchless Ericson
    clamp), contact normal = the SAT cross axis cross(d_i, d_j), and
    signed penetration = -(c_i - c_j).n.  Only INTERIOR solutions count
    (endpoint-clamped ones are vertex-region contacts with arbitrary
    cross axes — the point pass owns those); for interior solutions
    c_i - c_j is parallel to the cross axis, so |pen| IS the segment
    distance and the |pen| < shell window bounds both approach distance
    and accepted penetration.  The top-4 candidates per pair are then
    validated against BOTH hull unions (midpoint inside each within the
    margin), and the normal's final sign comes from j's binding hull
    facet — local, unlike a body-center heuristic, which flips on long
    tilted bodies.  At dt = 1 ms a step moves bodies well under the
    shell, so crossings are caught at first touch before they tunnel.
    Near-parallel edge pairs (face-face contact) are masked out.

    Everything here is a function of POSITIONS only, so `step` builds
    the manifold ONCE per timestep and the solver iterations reuse it
    (only velocities change inside the iteration loop) — the geometric
    sweep over E x E edge pairs is the expensive part and must not run
    10x per step.

    Returns (active [B,B,K] bool, pen [B,B,K], n [B,B,K,3],
    r_i/r_j [B,B,K,3] contact arms, m_eff [B,B,K], inv_I_world [B,3,3]).
    """
    b = state.pos.shape[0]
    R = quat.quat_to_rotmat(state.rot)  # [B, 3, 3]
    inv_I_world = _einsum("bij,bj,bkj->bik", R, params.inv_inertia, R)
    a_w = state.pos[:, None, :] + _einsum("bij,bej->bei", R, params.edge_a)
    b_w = state.pos[:, None, :] + _einsum("bij,bej->bei", R, params.edge_b)

    # broad phase, ordered pairs only (i < j): each unordered pair is
    # computed once and applied +/- to both bodies
    diff = state.pos[:, None, :] - state.pos[None, :, :]
    dist_c = jnp.linalg.norm(diff + jnp.eye(b)[..., None], axis=-1)
    rsum = params.radius[:, None] + params.radius[None, :]
    dynamic = (params.inv_mass > 0) & params.body_mask
    upper = jnp.triu(jnp.ones((b, b), bool), k=1)
    pair_ok = dynamic[:, None] & dynamic[None, :] & upper & (dist_c < rsum)

    # segment-segment closest points, [B_i, B_j, E_i, E_j]
    a1 = a_w[:, None, :, None, :]
    d1 = (b_w - a_w)[:, None, :, None, :]
    a2 = a_w[None, :, None, :, :]
    d2 = (b_w - a_w)[None, :, None, :, :]
    r0 = a1 - a2
    A = jnp.sum(d1 * d1, -1)
    E2 = jnp.sum(d2 * d2, -1)
    C = jnp.sum(d1 * r0, -1)
    F = jnp.sum(d2 * r0, -1)
    Bd = jnp.sum(d1 * d2, -1)
    den = A * E2 - Bd * Bd
    s = jnp.clip(
        jnp.where(den > 1e-12, (Bd * F - C * E2) / jnp.where(den > 1e-12, den, 1.0), 0.0),
        0.0, 1.0,
    )
    t = jnp.clip((Bd * s + F) / jnp.maximum(E2, 1e-12), 0.0, 1.0)
    s = jnp.clip((Bd * t - C) / jnp.maximum(A, 1e-12), 0.0, 1.0)
    c1 = a1 + s[..., None] * d1
    c2 = a2 + t[..., None] * d2

    # SAT cross axis; provisionally oriented from j toward i by body
    # centers — the FINAL orientation comes from j's binding hull facet
    # after selection (body centers misorient long tilted bodies whose
    # center sits on the far side of the contact)
    n = jnp.cross(jnp.broadcast_to(d1, c1.shape), jnp.broadcast_to(d2, c2.shape))
    n_norm = jnp.linalg.norm(n, axis=-1)
    sin_angle = n_norm / jnp.maximum(jnp.sqrt(A * E2), 1e-12)
    n = n / jnp.maximum(n_norm, 1e-9)[..., None]
    sign = jnp.sign(jnp.sum(n * diff[:, :, None, None, :], -1))
    n = n * jnp.where(sign == 0.0, 1.0, sign)[..., None]
    pen = -jnp.sum((c1 - c2) * n, -1)

    # endpoint-clamped solutions are VERTEX-region contacts (corner on
    # edge): their cross-axis normal is arbitrary, and the point pass
    # owns them — keep interior crossings only, where |pen| IS the
    # segment distance.  The |pen| window is symmetric because the
    # provisional sign may be flipped; crossings are caught at first
    # touch (|pen| ~ 0) either way, so penetration never outruns the
    # shell before the contact activates.
    interior = (s > 0.02) & (s < 0.98) & (t > 0.02) & (t < 0.98)
    active = (
        pair_ok[:, :, None, None]
        & params.edge_mask[:, None, :, None]
        & params.edge_mask[None, :, None, :]
        & (sin_angle > 0.05)
        & interior
        & (jnp.abs(pen) < shell)
    )

    # manifold cap: keep only the 4 deepest candidates per pair (Bullet's
    # persistent manifolds are 4-point too), then validate each contact
    # midpoint against BOTH bodies' hull unions — this rejects phantom
    # contacts across concavity openings (box-fallback / full-hull edges
    # span the mouth of a channel; the real decomposed hulls do not
    # contain the midpoint there).
    K = 4
    e1, e2 = pen.shape[2], pen.shape[3]
    NEG = jnp.float32(-1e30)
    score = jnp.where(active, pen, NEG).reshape(b, b, e1 * e2)
    # iterated argmax instead of lax.top_k: top_k lowers to a full sort,
    # which dominated the vmapped sim; 4 max+argmax reductions are cheap
    tops, idxs = [], []
    for _ in range(K):
        ix = jnp.argmax(score, axis=-1)  # [B, B]
        vx = jnp.take_along_axis(score, ix[..., None], axis=-1)[..., 0]
        tops.append(vx)
        idxs.append(ix)
        score = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, score.shape, 2)
            == ix[..., None],
            NEG,
            score,
        )
    top_pen = jnp.stack(tops, axis=-1)  # [B, B, K]
    top_idx = jnp.stack(idxs, axis=-1)

    def pick(v):  # [B,B,E,E,3] -> [B,B,K,3]
        flat = v.reshape(b, b, e1 * e2, 3)
        return jnp.take_along_axis(flat, top_idx[..., None], axis=2)

    c1k, c2k, nk = pick(c1), pick(c2), pick(n)
    pen_k = top_pen
    active_k = top_pen > NEG / 2

    m = 0.5 * (c1k + c2k)  # [B, B, K, 3]

    # hull-union membership of the midpoint, in both bodies' frames
    # (shared reduce with the point pass)
    def union_depth(p_world, frame):  # frame 'i' or 'j'
        if frame == "j":
            rel = p_world - state.pos[None, :, None, :]
            p_loc = _einsum("jab,ijka->ijkb", R, rel)
            facet = (params.plane_d + margin)[None, :, None, :] - _einsum(
                "jha,ijka->ijkh", params.plane_n, p_loc
            )
            group = params.plane_group[None, :, None, :]
            real = (params.plane_d < 1e8)[None, :, None, :]
        else:
            rel = p_world - state.pos[:, None, None, :]
            p_loc = _einsum("iab,ijka->ijkb", R, rel)
            facet = (params.plane_d + margin)[:, None, None, :] - _einsum(
                "iha,ijka->ijkh", params.plane_n, p_loc
            )
            group = params.plane_group[:, None, None, :]
            real = (params.plane_d < 1e8)[:, None, None, :]
        return _hull_union_reduce(facet, group, real, params.num_hull_parts)

    depth_j, hstar_j = union_depth(m, "j")
    depth_i, _ = union_depth(m, "i")
    active_k = active_k & (depth_j > 0.0) & (depth_i > 0.0)

    # FINAL normal orientation from j's binding facet: the facet whose
    # plane the midpoint is deepest behind points OUT of j at the
    # contact, so the contact normal (from j toward i) must have a
    # positive component along it.  This is local — immune to the
    # body-center heuristic's flip on long tilted bodies.
    facet_n_local = jnp.take_along_axis(
        jnp.broadcast_to(
            params.plane_n[None, :, None, :, :],
            (b, b, K, params.plane_n.shape[1], 3),
        ),
        hstar_j[..., None, None].repeat(3, -1),
        axis=-2,
    )[..., 0, :]  # [B, B, K, 3] in j's frame
    facet_n_world = _einsum("jab,ijkb->ijka", R, facet_n_local)
    dotf = jnp.sum(nk * facet_n_world, -1)
    flip = jnp.where(jnp.abs(dotf) > 1e-6, jnp.sign(dotf), 1.0)
    nk = nk * flip[..., None]
    pen_k = pen_k * flip
    active_k = active_k & (pen_k > -margin)

    r_i = m - state.pos[:, None, None, :]
    r_j = m - state.pos[None, :, None, :]
    rxn_i = jnp.cross(r_i, nk)
    rxn_j = jnp.cross(r_j, nk)
    ang_i = _einsum("ijka,iab,ijkb->ijk", rxn_i, inv_I_world, rxn_i)
    ang_j = _einsum("ijka,jab,ijkb->ijk", rxn_j, inv_I_world, rxn_j)
    m_eff = 1.0 / jnp.maximum(
        params.inv_mass[:, None, None]
        + params.inv_mass[None, :, None]
        + ang_i + ang_j,
        1e-9,
    )
    pen_k = jnp.where(active_k, pen_k, 0.0)
    return active_k, pen_k, nk, r_i, r_j, m_eff, inv_I_world


def _edge_impulses(
    state: RigidBodyState,
    params: RigidBodyParams,
    manifold,
    dt: float,
    baumgarte: float,
):
    """Velocity solve on a precomputed edge manifold (_edge_manifold).
    Only this part runs inside the solver iterations."""
    active_k, pen_k, nk, r_i, r_j, m_eff, inv_I_world = manifold
    u = (
        state.linvel[:, None, None, :]
        + jnp.cross(state.angvel[:, None, None, :], r_i)
        - state.linvel[None, :, None, :]
        - jnp.cross(state.angvel[None, :, None, :], r_j)
    )
    u_n = jnp.sum(u * nk, -1)
    # the Baumgarte bias is a TARGET separation velocity, not an additive
    # term: drive u_n up to `bias` and no further, else the solver
    # iterations pump velocity into resting contacts and launch bodies
    bias = jnp.minimum((baumgarte / dt) * jnp.maximum(pen_k, 0.0), 1.0)
    jn = m_eff * jnp.maximum(bias - u_n, 0.0)
    n_pair = jnp.maximum(jnp.sum(active_k, axis=2, keepdims=True), 1)
    jn = jnp.where(active_k, jn, 0.0) / n_pair

    u_t = u - u_n[..., None] * nk
    u_t_norm = jnp.linalg.norm(u_t, axis=-1)
    t_hat = u_t / jnp.maximum(u_t_norm, 1e-9)[..., None]
    mu = jnp.minimum(params.friction[:, None], params.friction[None, :])[
        :, :, None
    ]
    jt = jnp.minimum(m_eff * u_t_norm / n_pair, mu * jn)
    jt = jnp.where(active_k, jt, 0.0)

    imp = jn[..., None] * nk - jt[..., None] * t_hat  # on i (+), on j (-)
    sum_as_i = jnp.sum(imp, axis=(1, 2))  # [B, 3]
    sum_as_j = jnp.sum(imp, axis=(0, 2))
    dv = params.inv_mass[:, None] * (sum_as_i - sum_as_j)
    torque_i = jnp.sum(jnp.cross(r_i, imp), axis=(1, 2))
    torque_j = -jnp.sum(jnp.cross(r_j, imp), axis=(0, 2))
    dw = _einsum("bij,bj->bi", inv_I_world, torque_i + torque_j)
    return dv, dw


@partial(jax.jit, static_argnames=("iters",))
def step(
    params: RigidBodyParams,
    state: RigidBodyState,
    dt: float = DEFAULT_DT,
    gravity=DEFAULT_GRAVITY,
    iters: int = 10,
    baumgarte: float = 0.2,
    slop: float = 1e-4,
    heightfield: Heightfield | None = None,
) -> RigidBodyState:
    g = jnp.asarray(gravity, jnp.float32)
    hf = heightfield if heightfield is not None else Heightfield.flat()
    dyn = ((params.inv_mass > 0) & params.body_mask).astype(jnp.float32)[:, None]
    linvel = state.linvel + dyn * g * dt
    st = state.replace(linvel=linvel)

    # positions are fixed during the velocity iterations, so the edge
    # manifold (the expensive E x E geometric sweep) is built ONCE here
    edge_man = _edge_manifold(st, params)

    def solve(i, st):
        # Gauss-Seidel over the three passes: each sees the previous
        # pass's velocity update, so a contact already resolved by the
        # point pass leaves no approach velocity for the edge pass to
        # stop again (simultaneous application double-counts the stopping
        # impulse and LAUNCHES stacked drops).
        dv_p, dw_p = _ground_contacts(st, params, hf, dt, baumgarte, slop)
        st = st.replace(linvel=st.linvel + dv_p, angvel=st.angvel + dw_p)
        dv_s, dw_s = _pair_contacts(st, params, dt, baumgarte)
        st = st.replace(linvel=st.linvel + dv_s, angvel=st.angvel + dw_s)
        dv_e, dw_e = _edge_impulses(st, params, edge_man, dt, baumgarte)
        return st.replace(
            linvel=st.linvel + dv_e, angvel=st.angvel + dw_e
        )

    st = jax.lax.fori_loop(0, iters, solve, st)

    # integrate
    new_pos = st.pos + st.linvel * dt
    w_quat = jnp.concatenate([jnp.zeros_like(st.angvel[:, :1]), st.angvel], axis=-1)
    dq = 0.5 * quat.quat_mul(w_quat, st.rot)
    new_rot = quat.normalize(st.rot + dt * dq)
    # mild angular damping stabilizes resting contact (Bullet applies
    # similar default damping)
    return st.replace(
        pos=new_pos,
        rot=new_rot,
        linvel=st.linvel * (1.0 - 0.002),
        angvel=st.angvel * (1.0 - 0.01),
    )


@partial(jax.jit, static_argnames=("n_steps", "iters"))
def simulate(
    params: RigidBodyParams,
    state0: RigidBodyState,
    n_steps: int = 310,
    dt: float = DEFAULT_DT,
    gravity=DEFAULT_GRAVITY,
    iters: int = 10,
    heightfield: Heightfield | None = None,
) -> Tuple[RigidBodyState, RigidBodyState]:
    """Run the drop simulation, recording every step.

    Returns (trajectory_states with leading time axis [T, ...], final state).
    Matches the reference's recording loop
    (physical_simulation.py:125-152) which stores every body's (t, q) at
    every timestep.
    """

    def body(st, _):
        st = step(params, st, dt=dt, gravity=gravity, iters=iters,
                  heightfield=heightfield)
        return st, st

    final, traj = jax.lax.scan(body, state0, None, length=n_steps)
    return traj, final


def simulate_batch(params, state0, n_steps=310, **kwargs):
    """vmap over a leading scene axis of params/state — hundreds of scene
    variants in one XLA program (no reference counterpart; the reference is
    strictly sequential, SURVEY 2.2 parallelism audit)."""
    fn = lambda p, s: simulate(p, s, n_steps=n_steps, **kwargs)
    return jax.vmap(fn)(params, state0)
