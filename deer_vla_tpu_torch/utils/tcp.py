"""World <-> tool-center-point action frames (the JAX package's
``utils/tcp.py``; the reference's robot_flamingo/utils.py:16-78), for the
``--tcp_rel`` training and rollout option.

Euler convention "XYZ" intrinsic (pytorch3d's: R = X(a) @ Y(b) @ Z(c)
applied to column vectors).  Orientation deltas are scaled by 0.01 to act
as near-infinitesimal rotations and scaled back after, as in the reference.
The functions take tensors (or anything ``torch.as_tensor`` takes, such as
one (7,) host action) and compute in fp32 on the input's device.
"""

from __future__ import annotations

import math

import torch


def _stack3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rx(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3([(o, z, z), (z, c, -s), (z, s, c)])


def _ry(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3([(c, z, s), (z, o, z), (-s, z, c)])


def _rz(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3([(c, -s, z), (s, c, z), (z, z, o)])


def euler_angles_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """XYZ convention: R = Rx(a) @ Ry(b) @ Rz(c); euler (..., 3)."""
    return _rx(euler[..., 0]) @ _ry(euler[..., 1]) @ _rz(euler[..., 2])


def matrix_to_euler_angles(m: torch.Tensor) -> torch.Tensor:
    """The inverse of ``euler_angles_to_matrix`` (pytorch3d's XYZ
    extraction): for R = Rx Ry Rz, m[0, 2] = sin(b)."""
    b = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], -1)


def _wrap(x):
    x = torch.where(x < -math.pi, x + 2 * math.pi, x)
    return torch.where(x > math.pi, x - 2 * math.pi, x)


def _rows(action, robot_obs):
    """(N, 7) fp32 actions and their (N, D) robot_obs rows; one robot_obs
    row broadcasts over a (k, 7) plan."""
    action = torch.as_tensor(action)
    robot_obs = torch.as_tensor(robot_obs, device=action.device)
    a = action.reshape(-1, 7).float()
    ro = robot_obs.float().broadcast_to(
        action.shape[:-1] + robot_obs.shape[-1:]).reshape(-1,
                                                          robot_obs.shape[-1])
    return action.shape, a, ro


def world_to_tcp_frame(action, robot_obs) -> torch.Tensor:
    """action (..., 7) world-frame relative -> tcp-frame relative, at the
    tcp pose robot_obs[..., 3:6]."""
    shape, action, robot_obs = _rows(action, robot_obs)
    world_T_tcp = euler_angles_to_matrix(robot_obs[:, 3:6])
    tcp_T_world = world_T_tcp.transpose(-1, -2)  # the rotation's inverse
    pos_tcp = (tcp_T_world @ action[:, :3, None])[..., 0]
    orn_w_rel = action[:, 3:6] * 0.01
    world_T_tcp_new = euler_angles_to_matrix(robot_obs[:, 3:6] + orn_w_rel)
    tcp_new_T_tcp_old = world_T_tcp_new.transpose(-1, -2) @ world_T_tcp
    orn_tcp = _wrap(matrix_to_euler_angles(tcp_new_T_tcp_old)) * 100.0
    return torch.cat([pos_tcp, orn_tcp, action[:, -1:]], -1).reshape(shape)


def tcp_to_world_frame(action, robot_obs) -> torch.Tensor:
    """action (..., 7) tcp-frame relative -> world-frame relative, at the
    tcp pose robot_obs[..., 3:6]."""
    shape, action, robot_obs = _rows(action, robot_obs)
    world_T_tcp = euler_angles_to_matrix(robot_obs[:, 3:6])
    pos_w = (world_T_tcp @ action[:, :3, None])[..., 0]
    orn_tcp_rel = action[:, 3:6] * 0.01
    tcp_new_T_tcp_old = euler_angles_to_matrix(orn_tcp_rel)
    world_T_tcp_new = world_T_tcp @ tcp_new_T_tcp_old.transpose(-1, -2)
    orn_w_new = matrix_to_euler_angles(world_T_tcp_new)
    orn_w_rel = _wrap(orn_w_new - robot_obs[:, 3:6]) * 100.0
    return torch.cat([pos_w, orn_w_rel, action[:, -1:]], -1).reshape(shape)
