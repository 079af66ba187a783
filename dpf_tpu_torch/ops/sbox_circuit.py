"""AES S-box as a boolean circuit, for bitsliced evaluation.

The port's own copy of the two circuits of ``dpf_tpu/ops/sbox_circuit.py``
(the port imports nothing of ``dpf_tpu``).  Primary circuit: Boyar-Peralta's
113-gate / depth-16 forward S-box (J. Boyar, R. Peralta, "A depth-16 circuit
for the AES S-box", 2011 — public-domain circuit).  Both circuits are checked
on all 256 inputs against ``aes_np.SBOX`` in ``tests/port/test_torch_aes.py``.

A plane is any value supporting ``^``, ``&`` and ``~`` elementwise with
two's-complement ``~``: torch ``int32`` tensors (the plain PyTorch path), or
the symbolic tracer of ``gen_sbox.py``, which turns the circuit into the CUDA
kernels' S-box (``csrc/sbox_bp113.cuh``).

Convention: ``x[0]`` is the **most significant bit** of the S-box input byte,
``out[0]`` the MSB of the output (Boyar-Peralta's ordering).  Callers using
LSB-first plane layouts must reverse on the way in and out.
"""

from __future__ import annotations


def sbox_bp113(x):
    """Forward AES S-box on 8 planes, MSB-first. 113 gates (32 AND, 77 XOR,
    4 XNOR).  Returns 8 output planes, MSB-first."""
    (x0, x1, x2, x3, x4, x5, x6, x7) = x

    # --- top linear transform (input expansion to 22 shared signals) ---
    y14 = x3 ^ x5
    y13 = x0 ^ x6
    y9 = x0 ^ x3
    y8 = x0 ^ x5
    t0 = x1 ^ x2
    y1 = t0 ^ x7
    y4 = y1 ^ x3
    y12 = y13 ^ y14
    y2 = y1 ^ x0
    y5 = y1 ^ x6
    y3 = y5 ^ y8
    t1 = x4 ^ y12
    y15 = t1 ^ x5
    y20 = t1 ^ x1
    y6 = y15 ^ x7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = x7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = x0 ^ y16

    # --- middle non-linear section (GF(2^4) inversion tower) ---
    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & x7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    z0 = t44 & y15
    z1 = t37 & y6
    z2 = t33 & x7
    z3 = t43 & y16
    z4 = t40 & y1
    z5 = t29 & y7
    z6 = t42 & y11
    z7 = t45 & y17
    z8 = t41 & y10
    z9 = t44 & y12
    z10 = t37 & y3
    z11 = t33 & y4
    z12 = t43 & y13
    z13 = t40 & y5
    z14 = t29 & y2
    z15 = t42 & y9
    z16 = t45 & y14
    z17 = t41 & y8

    # --- bottom linear transform (shared-XOR output reconstruction) ---
    t46 = z15 ^ z16
    t47 = z10 ^ z11
    t48 = z5 ^ z13
    t49 = z9 ^ z10
    t50 = z2 ^ z12
    t51 = z2 ^ z5
    t52 = z7 ^ z8
    t53 = z0 ^ z3
    t54 = z6 ^ z7
    t55 = z16 ^ z17
    t56 = z12 ^ t48
    t57 = t50 ^ t53
    t58 = z4 ^ t46
    t59 = z3 ^ t54
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t64 = z4 ^ t59
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    s0 = t59 ^ t63
    s6 = ~(t56 ^ t62)
    s7 = ~(t48 ^ t60)
    t67 = t64 ^ t65
    s3 = t53 ^ t66
    s4 = t51 ^ t66
    s5 = t47 ^ t65
    s1 = ~(t64 ^ s3)
    s2 = ~(t55 ^ t67)

    return [s0, s1, s2, s3, s4, s5, s6, s7]


def sbox_bp113_lowlive(x):
    """Forward AES S-box, register-budgeted schedule: same GF(2^4) tower
    math as :func:`sbox_bp113`, restructured for a small live set.

    Rationale: the plain BP113 transcription peaks at 29 live values (36
    with the 8 inputs pinned; counted in the JAX package by
    scripts/sbox_liveness.py) because its 22 shared y-signals each have one
    consumer in the early t-products and one in the z-products ~70 gates
    later, so they stay live across the entire nonlinear middle section.
    Each live value is a register per thread in the port's CUDA kernels.

    This schedule rematerializes the y-signals instead of holding them —
    the Käsper-Schwabe register-budget idea (CHES 2009), rederived for a
    3-operand SSA target so the budget shows up as DAG width rather than
    explicit register moves:

      phase A: t-products, consuming freshly computed y's; carries only
               t21..t24 forward,
      phase B: the GF(2^4) inversion core (working set ~10),
      phase C: z-products with each y recomputed from the inputs via
               short XOR identities (e.g. y15 = x0^x3^x4^x6,
               y11 = y16^t0, y10 = y11^y17), interleaved with the shared
               output-XOR tree so each z dies within a few gates.

    ~43 extra XORs (156 ops vs 113) buy a peak cut of 24 live values (26
    inputs-pinned) vs BP113's 29 (36) — recomputation is issue-rate-cheap,
    spills are not.  The binding region is phase C, whose cut is close to
    inherent: 8 pinned inputs + the 9 tower coefficients (t29..t45, each
    feeding two z-products) are live across the whole output
    reconstruction, so ~17 is the floor for any schedule of this DAG.
    Checked on all 256 inputs in tests/port/test_torch_aes.py.
    """
    (x0, x1, x2, x3, x4, x5, x6, x7) = x

    # --- phase A: shared-signal products, y's computed on demand --------
    y13 = x0 ^ x6
    y14 = x3 ^ x5
    y12 = y13 ^ y14
    y15 = (y12 ^ x4) ^ x5
    t2 = y12 & y15
    t0 = x1 ^ x2
    y8 = x0 ^ x5
    y6 = y15 ^ x7
    y3 = (t0 ^ y8) ^ (x6 ^ x7)
    t3 = y3 & y6
    t4 = t3 ^ t2
    y1 = t0 ^ x7
    y4 = y1 ^ x3
    t5 = y4 & x7
    t6 = t5 ^ t2
    y16 = (x2 ^ x6) ^ (x4 ^ x5)
    t7 = y13 & y16
    y5 = y1 ^ x6
    t8 = y5 & y1
    t9 = t8 ^ t7
    y11 = y16 ^ t0
    y2 = y1 ^ x0
    y7 = y11 ^ x7
    t10 = y2 & y7
    t11 = t10 ^ t7
    y9 = x0 ^ x3
    t12 = y9 & y11
    y17 = y14 ^ (x0 ^ x2)
    t13 = y14 & y17
    t14 = t13 ^ t12
    y10 = y11 ^ y17
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    y20 = y11 ^ y9
    t21 = t17 ^ y20
    y19 = y16 ^ (x1 ^ x3)
    t22 = t18 ^ y19
    y18 = x0 ^ y16
    t24 = t20 ^ y18
    y21 = y18 ^ x6
    t23 = t19 ^ y21

    # --- phase B: GF(2^4) inversion core (identical to BP113) ----------
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41

    # --- phase C: z-products with rematerialized y's, streamed into the
    # shared output tree (t46..t67 exactly as in BP113, reordered so each
    # z dies within a few gates of its creation) -------------------------
    c_t0 = x1 ^ x2
    c_y16 = (x2 ^ x6) ^ (x4 ^ x5)
    c_y11 = c_y16 ^ c_t0
    z6 = t42 & c_y11
    c_y9 = x0 ^ x3
    z15 = t42 & c_y9
    c_y14 = x3 ^ x5
    z16 = t45 & c_y14
    c_y17 = c_y14 ^ (x0 ^ x2)
    z7 = t45 & c_y17
    t46 = z15 ^ z16
    t54 = z6 ^ z7
    c_y10 = c_y11 ^ c_y17
    z8 = t41 & c_y10
    c_y8 = x0 ^ x5
    z17 = t41 & c_y8
    t52 = z7 ^ z8
    t55 = z16 ^ z17
    c_y7 = c_y11 ^ x7
    z5 = t29 & c_y7
    c_y1 = c_t0 ^ x7
    c_y2 = c_y1 ^ x0
    z14 = t29 & c_y2
    z4 = t40 & c_y1
    c_y5 = c_y1 ^ x6
    z13 = t40 & c_y5
    t48 = z5 ^ z13
    t58 = z4 ^ t46
    z2 = t33 & x7
    c_y4 = c_y1 ^ x3
    z11 = t33 & c_y4
    t51 = z2 ^ z5
    c2_y16 = (x2 ^ x6) ^ (x4 ^ x5)  # remat: frees c_y16's 40-gate hold
    z3 = t43 & c2_y16
    c_y13 = x0 ^ x6
    z12 = t43 & c_y13
    t50 = z2 ^ z12
    t56 = z12 ^ t48
    t59 = z3 ^ t54
    t64 = z4 ^ t59
    c_y15 = (x0 ^ x3) ^ (x4 ^ x6)
    z0 = t44 & c_y15
    c_y12 = (c_y15 ^ x4) ^ x5
    z9 = t44 & c_y12
    t53 = z0 ^ z3
    t57 = t50 ^ t53
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    s7 = ~(t48 ^ t60)
    c_y6 = c_y15 ^ x7
    z1 = t37 & c_y6
    c_y3 = ((x0 ^ x1) ^ (x2 ^ x5)) ^ (x6 ^ x7)  # remat, not c_y5^c_y8
    z10 = t37 & c_y3
    t47 = z10 ^ z11
    t49 = z9 ^ z10
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    s0 = t59 ^ t63
    s6 = ~(t56 ^ t62)
    t67 = t64 ^ t65
    s3 = t53 ^ t66
    s4 = t51 ^ t66
    s5 = t47 ^ t65
    s1 = ~(t64 ^ s3)
    s2 = ~(t55 ^ t67)

    return [s0, s1, s2, s3, s4, s5, s6, s7]


# "bp113" (the default, as in the JAX package) is the plain Boyar-Peralta
# transcription; "lowlive" the register-budgeted rematerializing schedule.
SBOX_IMPLS = {"bp113": sbox_bp113, "lowlive": sbox_bp113_lowlive}
