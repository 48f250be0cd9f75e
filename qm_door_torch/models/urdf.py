"""Host-side URDF -> model-constants compiler (port of
qm_door_tpu/models/urdf.py: numpy and xml.etree, no tensors).

Replaces the role of pinocchio's URDF parsing + OCS2's
``centroidal_model::createPinocchioInterface`` (reference call site:
qm_interface/src/QMInterface.cpp:408-416): the full URDF tree is reduced to
the actuated-joint skeleton, every non-actuated joint is welded at its zero
configuration, and welded bodies' inertias are lumped into their nearest
actuated ancestor. The output is a plain dict of numeric constants (JSON
serializable) that :func:`qm_door_torch.models.model.from_dict` turns into
a RobotModel of tensors on a device (``load_model`` reads it from a JSON
file). This runs on the host at model-build time only.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


def _rpy_to_rot(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_origin(elem):
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(v) for v in elem.get("xyz", "0 0 0").split()])
    rpy = np.array([float(v) for v in elem.get("rpy", "0 0 0").split()])
    return _rpy_to_rot(rpy), xyz


def _parse_inertial(link_elem):
    inertial = link_elem.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    R, com = _parse_origin(inertial.find("origin"))
    ie = inertial.find("inertia")
    ixx, iyy, izz = (float(ie.get(k)) for k in ("ixx", "iyy", "izz"))
    ixy, ixz, iyz = (float(ie.get(k, "0")) for k in ("ixy", "ixz", "iyz"))
    I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # Rotate inertia (given about the inertial frame) into the link frame.
    return mass, com, R @ I_local @ R.T


def _merge_inertia(m1, c1, I1, m2, c2, I2):
    """Combine two bodies (masses, coms, inertias-about-com, same frame)."""
    m = m1 + m2
    if m <= 0:
        return m, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m

    def shift(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, I1) + shift(m2, c2, I2)


def compile_urdf(urdf_path, actuated_joints, frames, root_link=None):
    """Reduce a URDF to fixed-size model constants.

    Args:
      urdf_path: path to the URDF file.
      actuated_joints: ordered list of joint names that remain articulated;
        this order defines the generalized-coordinate layout q[6:].
      frames: list of link names to export as operational frames
        (feet, end-effector, base, ...).
      root_link: optional root link name (auto-detected if None).

    Returns a JSON-friendly dict of model constants.
    """
    tree = ET.parse(urdf_path)
    robot = tree.getroot()

    links = {}
    for link in robot.findall("link"):
        links[link.get("name")] = _parse_inertial(link)

    joints = {}
    children_of = {}
    child_links = set()
    for joint in robot.findall("joint"):
        name = joint.get("name")
        parent = joint.find("parent").get("link")
        child = joint.find("child").get("link")
        R, p = _parse_origin(joint.find("origin"))
        axis_elem = joint.find("axis")
        axis = (
            np.array([float(v) for v in axis_elem.get("xyz").split()])
            if axis_elem is not None
            else np.array([1.0, 0.0, 0.0])
        )
        limit = joint.find("limit")
        lim = dict(
            effort=float(limit.get("effort", "inf")) if limit is not None else np.inf,
            velocity=float(limit.get("velocity", "inf")) if limit is not None else np.inf,
            lower=float(limit.get("lower", "-inf")) if limit is not None else -np.inf,
            upper=float(limit.get("upper", "inf")) if limit is not None else np.inf,
        )
        joints[name] = dict(
            type=joint.get("type"), parent=parent, child=child, R=R, p=p, axis=axis, **lim
        )
        children_of.setdefault(parent, []).append(name)
        child_links.add(child)

    if root_link is None:
        roots = [l for l in links if l not in child_links]
        if len(roots) != 1:
            raise ValueError(f"ambiguous root links: {roots}")
        root_link = roots[0]

    actuated_set = set(actuated_joints)
    n_bodies = len(actuated_joints) + 1

    body_mass = np.zeros(n_bodies)
    body_com = np.zeros((n_bodies, 3))
    body_inertia = np.zeros((n_bodies, 3, 3))
    joint_info = {}  # name -> dict(parent_body, R, p, axis, limits)
    frame_info = {}  # link name -> (body_idx, R, p)
    body_order = []  # discovery order of actuated joint names

    def lump(body_idx, R_bl, p_bl, link_name):
        """Accumulate link inertia (expressed via body->link transform) into body."""
        m2, c2_l, I2_l = links[link_name]
        c2 = R_bl @ c2_l + p_bl
        I2 = R_bl @ I2_l @ R_bl.T
        body_mass[body_idx], body_com[body_idx], body_inertia[body_idx] = _merge_inertia(
            body_mass[body_idx], body_com[body_idx], body_inertia[body_idx], m2, c2, I2
        )

    def visit(link_name, body_idx, R_bl, p_bl):
        """Visit `link_name` whose frame sits at (R_bl, p_bl) in body `body_idx`."""
        lump(body_idx, R_bl, p_bl, link_name)
        if link_name in frames:
            frame_info[link_name] = (body_idx, R_bl.copy(), p_bl.copy())
        for jname in children_of.get(link_name, []):
            j = joints[jname]
            Rj = R_bl @ j["R"]
            pj = R_bl @ j["p"] + p_bl
            if jname in actuated_set:
                body_order.append(jname)
                new_idx = 1 + actuated_joints.index(jname)
                joint_info[jname] = dict(
                    parent_body=body_idx,
                    R=Rj,
                    p=pj,
                    axis=j["axis"],
                    effort=j["effort"],
                    velocity=j["velocity"],
                    lower=j["lower"],
                    upper=j["upper"],
                )
                # Child link frame == joint frame at q=0.
                visit(j["child"], new_idx, np.eye(3), np.zeros(3))
            else:
                # Weld at zero configuration (continuous/revolute extras included,
                # matching OCS2's reduced model at neutral config).
                visit(j["child"], body_idx, Rj, pj)

    visit(root_link, 0, np.eye(3), np.zeros(3))

    missing = actuated_set - set(body_order)
    if missing:
        raise ValueError(f"actuated joints not found in URDF tree: {missing}")
    missing_frames = set(frames) - set(frame_info)
    if missing_frames:
        raise ValueError(f"frames not found in URDF tree: {missing_frames}")

    return dict(
        name=robot.get("name"),
        root_link=root_link,
        joint_names=list(actuated_joints),
        joint_parent=[int(joint_info[j]["parent_body"]) for j in actuated_joints],
        joint_rot=[joint_info[j]["R"].tolist() for j in actuated_joints],
        joint_trans=[joint_info[j]["p"].tolist() for j in actuated_joints],
        joint_axis=[(np.asarray(joint_info[j]["axis"]) / np.linalg.norm(joint_info[j]["axis"])).tolist() for j in actuated_joints],
        effort_limit=[joint_info[j]["effort"] for j in actuated_joints],
        velocity_limit=[joint_info[j]["velocity"] for j in actuated_joints],
        pos_lower=[joint_info[j]["lower"] for j in actuated_joints],
        pos_upper=[joint_info[j]["upper"] for j in actuated_joints],
        body_mass=body_mass.tolist(),
        body_com=body_com.tolist(),
        body_inertia=body_inertia.tolist(),
        frame_names=list(frames),
        frame_parent=[int(frame_info[f][0]) for f in frames],
        frame_rot=[frame_info[f][1].tolist() for f in frames],
        frame_trans=[frame_info[f][2].tolist() for f in frames],
    )
