"""Typed configuration tree — single source for every knob of the stack.

Mirrors the reference's three config tiers (task.info / reference.info /
gait.info parsed with boost ptree, ROS params, dynamic_reconfigure gains —
see SURVEY.md §5) as plain dataclasses. Default values reproduce
qm_controllers/config/task.info, reference.info and the dynamic_reconfigure
defaults (qm_wbc/cfg/wbcWigeht.cfg) verbatim.

The port's own copy of ``qm_door_tpu/config.py`` (numpy and dataclasses
only), kept field for field so one set of settings drives either package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SqpSettings:
    dt: float = 0.015
    sqp_iterations: int = 1
    delta_tol: float = 1e-4
    g_max: float = 1e-2
    g_min: float = 1e-6
    inequality_mu: float = 0.1         # relaxed-barrier mu (friction cone)
    inequality_delta: float = 5.0      # relaxed-barrier delta
    project_equalities: bool = True
    integrator: str = "rk2"
    # linesearch
    min_step: float = 1e-2
    max_step: float = 1.0
    armijo_factor: float = 1e-4
    step_reduction: float = 0.5
    # Levenberg-style diagonal shift applied when the projected Hessian
    # loses positive-definiteness (OCS2 hessianCorrection DIAGONAL_SHIFT).
    hessian_shift: float = 1e-5
    # backend choices: projection "chol" (Cholesky projector) or "qr"
    # (orthonormal basis); riccati "parallel" (associative scan, O(log N)
    # depth) or "scan" (sequential sweep)
    projection: str = "chol"
    # riccati "scan" (sequential sweep — fastest at production batch sizes:
    # cheap batched matmuls; the associative-scan "parallel" variant wins on
    # single-scenario latency / very long horizons)
    riccati: str = "scan"
    # number of geometric linesearch candidates evaluated per iteration
    # (the reference walks alpha down to 1e-2; warm-started MPC accepts
    # alpha >= 0.125 essentially always, and a rejected step keeps the
    # previous trajectory)
    linesearch_steps: int = 4
    # >0: linearize nodes in chunks of this size (bounds jacfwd workspace
    # memory for large scenario batches); 0 = all nodes at once
    lin_chunk: int = 0
    # RK2 discrete-sensitivity mode: "frozen" reuses the first-stage flow
    # Jacobian for the second stage (defects stay exact RK2; stationarity
    # error O(dt^2) — measured equivalent downstream) and saves the second
    # 24-tangent AD sweep; "rk2" = exact OCS2 SensitivityIntegrator behavior
    sensitivity: str = "frozen"
    # Linearization derivative mode (transcription._node_linearization):
    #   "f32"  — 21-tangent AD sweep through the full stage-1 graph (exact);
    #   "bf16" — same sweep with bfloat16 tangents;
    #   "analytic" — closed-form geometric derivatives (momentum-rate and
    #            EE rows analytic, 6-cotangent REVERSE pass through the CMM,
    #            FK-only foot-velocity sweep): no full-graph sweep at all,
    #            exact to roundoff;
    #   "analytic_bf16" — analytic structure with the two remaining small
    #            sweeps in bf16 (the batched serving setting).
    # The torch port implements "analytic" and "analytic_bf16" so far.
    # Defects, constraint values, and the Gv projection rows stay f32 in
    # every mode, so the SQP fixed point is unchanged — an inexact Jacobian
    # only perturbs the convergence PATH (inexact Newton).
    lin_tangents: str = "f32"
    # unroll factor of the JAX package's batch-major Riccati scans; the
    # torch port's sweeps are Python loops and ignore it.
    riccati_unroll: int = 1


@dataclass
class MpcSettings:
    time_horizon: float = 1.0
    mpc_frequency: float = 100.0
    mrt_frequency: float = 1000.0
    cold_start: bool = False


@dataclass
class SwingSettings:
    lift_off_velocity: float = 0.05
    touch_down_velocity: float = -0.1
    swing_height: float = 0.15
    touchdown_after_horizon: float = 0.2
    swing_time_scale: float = 0.15


@dataclass
class CostSettings:
    # Q diagonal (30), task.info "Q" with scaling 1e0.
    q_diag: np.ndarray = field(
        default_factory=lambda: np.array(
            [50.0, 50.0, 300.0, 10.0, 30.0, 30.0]          # normalized momentum
            + [1000.0, 1000.0, 3000.0, 1000.0, 2000.0, 2000.0]  # base pose
            + [5.0, 5.0, 2.5] * 4                          # leg joints
            + [0.0, 0.0, 5.0, 0.0, 0.0, 0.0]               # arm joints
        )
    )
    # R diagonal in task space (30), task.info "R" with scaling 1e-3; the
    # (12:24) block is foot-velocity weight mapped through the base->feet
    # Jacobian at the nominal configuration (QMInterface.cpp:274-299).
    r_scaling: float = 1e-3
    r_forces: float = 5.0
    r_foot_velocity: float = 5000.0
    r_arm_velocity: float = 1000.0
    # end-effector soft constraint penalties (task.info endEffector)
    ee_mu_position: float = 2000.0
    ee_mu_orientation: float = 1000.0
    final_ee_mu_position: float = 2000.0
    final_ee_mu_orientation: float = 1000.0


@dataclass
class SelfCollisionSettings:
    """ocs2_self_collision role (QMInterface.h:19,50,89 declares the
    geometry interface but never instantiates the constraint; mu = 0 keeps
    the same shipped behavior while the capability exists)."""
    mu: float = 0.0          # > 0 enables the soft constraint
    delta: float = 0.02      # relaxed-barrier quadratic extension
    margin: float = 0.05     # clearance added to the sphere radii


@dataclass
class FrictionSettings:
    friction_coefficient: float = 0.7
    barrier_mu: float = 0.1
    barrier_delta: float = 5.0
    cone_regularization: float = 25.0


@dataclass
class JointLimitSettings:
    position_mu: float = 0.1
    position_delta: float = 1e-3
    velocity_mu: float = 0.1
    velocity_delta: float = 1e-3
    arm_velocity_lower: np.ndarray = field(
        default_factory=lambda: -np.array([0.628, 0.628, 0.628, 0.837, 0.837, 0.837])
    )
    arm_velocity_upper: np.ndarray = field(
        default_factory=lambda: np.array([0.628, 0.628, 0.628, 0.837, 0.837, 0.837])
    )


@dataclass
class ModelSettings:
    position_error_gain: float = 0.0
    phase_transition_stance_time: float = 0.1
    # Quadruped-only variant (BASELINE config #1; reference
    # ModelSettings.h:147-153 leg-only joint set): the arm is WELDED at its
    # default pose — arm velocity inputs pinned to zero through the equality
    # projection, EE tracking cost off, WBC holds the arm with the joint-PD
    # task. A mask, not a shape change (fixed-shape mode-switching rule).
    arm_locked: bool = False


@dataclass
class WbcSettings:
    friction_coefficient: float = 0.3  # task.info frictionConeTask
    # dynamic_reconfigure defaults (qm_wbc/cfg/wbcWigeht.cfg)
    swing_kp: float = 350.0
    swing_kd: float = 37.0
    base_height_kp: float = 400.0
    base_height_kd: float = 140.0
    base_linear_kp: float = 400.0
    base_linear_kd: float = 100.0
    base_angular_kp: float = 400.0
    base_angular_kd: float = 140.0
    arm_joint_kp: np.ndarray = field(
        default_factory=lambda: np.array([4000.0, 4200.0, 4000.0, 4000.0, 4200.0, 6000.0])
    )
    arm_joint_kd: np.ndarray = field(default_factory=lambda: np.full(6, 75.0))
    ee_linear_kp: np.ndarray = field(default_factory=lambda: np.full(3, 3000.0))
    ee_linear_kd: np.ndarray = field(default_factory=lambda: np.full(3, 75.0))
    ee_angular_kp: np.ndarray = field(default_factory=lambda: np.full(3, 2000.0))
    ee_angular_kd: np.ndarray = field(default_factory=lambda: np.full(3, 75.0))
    swing_task_weight: float = 100.0
    arm_init_time: float = 10.0  # HierarchicalWbc switches taskInit->task1 at t=10
    # dense-QP solver
    qp_iterations: int = 30


@dataclass
class ForceTrackingSettings:
    """Force-tracking NMPC extension (BASELINE config #4; the reference's
    force-tracking branch models the arm EE as an extra contact —
    README.md 'three branches'). Input widens 30->36 with an EE wrench."""

    # R weights of the wrench input: tracking stiffness toward the wrench
    # reference (same 1e-3 scaling convention as CostSettings.r_scaling).
    # Deliberately ~100x the foot-force weight: the wrench is a *commanded*
    # quantity — with a weight comparable to the foot forces the optimizer
    # recruits it as a free actuator against unrelated cost residuals
    # (measured: sign-flipped wrench at r_ee_force = 5).
    r_ee_force: float = 500.0
    r_ee_torque: float = 2000.0
    # soft box on the commanded wrench (N / N m)
    force_limit: float = 80.0
    torque_limit: float = 15.0
    limit_mu: float = 0.1
    limit_delta: float = 1e-3
    # Hierarchy level of the WBC wrench-tracking equality (wbc/force.py):
    # 0 pins W at the top level with the EoM (an external wrench is not a
    # decision the lower levels may spend); 2 keeps the legacy slot next to
    # the contact-force task for A/B against the round-2 tuned demo.
    wrench_priority: int = 0


@dataclass
class ReferenceSettings:
    target_displacement_velocity: float = 0.2
    target_rotation_velocity: float = 0.1
    com_height: float = 0.4
    default_joint_state: np.ndarray = field(
        default_factory=lambda: np.array(
            [0.0, 0.8, -1.5] * 4 + [0.0, 1.11, -0.69, -0.40, 0.0, 0.0]
        )
    )


@dataclass
class ControllerSettings:
    # PD+ff command law (QMController::updateControlLaw)
    leg_kp: float = 0.0
    leg_kd: float = 3.0
    arm_kp: float = 0.0    # qm_controllers/cfg/weight.cfg defaults
    arm_kd: float = 0.5
    leg_pd_start_time: float = 10.0  # legs use pure feedforward until t>10
    safety_tilt_limit: float = float(np.pi / 2)


@dataclass
class QmConfig:
    sqp: SqpSettings = field(default_factory=SqpSettings)
    mpc: MpcSettings = field(default_factory=MpcSettings)
    swing: SwingSettings = field(default_factory=SwingSettings)
    cost: CostSettings = field(default_factory=CostSettings)
    friction: FrictionSettings = field(default_factory=FrictionSettings)
    self_collision: SelfCollisionSettings = field(default_factory=SelfCollisionSettings)
    joint_limits: JointLimitSettings = field(default_factory=JointLimitSettings)
    model: ModelSettings = field(default_factory=ModelSettings)
    wbc: WbcSettings = field(default_factory=WbcSettings)
    reference: ReferenceSettings = field(default_factory=ReferenceSettings)
    controller: ControllerSettings = field(default_factory=ControllerSettings)
    force_tracking: ForceTrackingSettings = field(default_factory=ForceTrackingSettings)

    def initial_state(self) -> np.ndarray:
        """task.info initialState (30)."""
        x = np.zeros(30)
        x[8] = 0.4
        x[12:30] = self.reference.default_joint_state
        return x


def default_config() -> QmConfig:
    return QmConfig()


def quad_only_config() -> QmConfig:
    """AlienGo quadruped-only preset (BASELINE config #1): arm welded at the
    default pose, EE pose tracking off, WBC arm-joint hold task permanent."""
    cfg = QmConfig()
    cfg.model.arm_locked = True
    cfg.cost.ee_mu_position = 0.0
    cfg.cost.ee_mu_orientation = 0.0
    cfg.cost.final_ee_mu_position = 0.0
    cfg.cost.final_ee_mu_orientation = 0.0
    # The locked WBC stack (hierarchical_wbc arm_locked=True) swaps the EE
    # rows of T1 for the arm-joint hold while KEEPING base height/angular
    # and swing tasks; the init stack is never needed.
    cfg.wbc.arm_init_time = -1.0
    return cfg
