"""Canonical H3.6M-17 skeleton constants (a numpy copy of the JAX package's
`kasportsformer_tpu/skeleton.py`; the port imports nothing of that package).

One home for the joint/bone/limb structure the reference scatters across
`utils/static_values.py`, `model/modules/graph.py:16`,
`model/modules/bone_refusion.py:34` and `model/KASportsFormer.py:46`.

Joint indexing (H3.6M 17-joint convention, reference
`utils/static_values.py:23-41`):

    0 pelvis (bottom torso)   1-3 right leg (hip/knee/foot)
    4-6 left leg              7 spine  8 thorax  9 neck  10 head
    11-13 left arm (shoulder/elbow/wrist)
    14-16 right arm
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 17
NUM_BONES = 16

JOINT_LABELS = (
    "Bottom torso",
    "Right hip", "Right knee", "Right foot",
    "Left hip", "Left knee", "Left foot",
    "Spine", "Thorax", "Neck", "Center head",
    "Left shoulder", "Left elbow", "Left wrist",
    "Right shoulder", "Right elbow", "Right wrist",
)

LOWER_BODY_JOINTS = tuple(range(1, 7))
UPPER_BODY_JOINTS = tuple(range(7, 17))

# 16 skeleton bones as (child, parent) index pairs, in the order the
# reference's bone decomposition emits them (`model/KASportsFormer.py:46-47`).
# direction = joints[BONE_CHILD] - joints[BONE_PARENT].
BONE_CHILD = (0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15)
BONE_PARENT = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)

# The same 16 bones as (proximal, distal) pairs, ordered as used by the limb
# length/angle losses (`utils/loss_calc.py:33-38`).
LIMB_PAIRS = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)

# 18 bone-index pairs whose inter-bone angles the cosine-similarity losses
# penalize (`utils/loss_calc.py:69-72`).
ANGLE_PAIRS = (
    (0, 3), (0, 6), (3, 6), (0, 1), (1, 2),
    (3, 4), (4, 5), (6, 7), (7, 10), (7, 13),
    (8, 13), (10, 13), (7, 8), (8, 9), (10, 11),
    (11, 12), (13, 14), (14, 15),
)

# Undirected skeleton adjacency used by the spatial GCN
# (`model/modules/graph.py:16-17`). Symmetric, no self loops.
SKELETON_EDGES = {
    0: (1, 7, 4), 1: (2, 0), 2: (3, 1), 3: (2,),
    4: (5, 0), 5: (6, 4), 6: (5,),
    7: (0, 8), 8: (7, 9, 11, 14), 9: (8, 10), 10: (9,),
    11: (12, 8), 12: (13, 11), 13: (12,),
    14: (15, 8), 15: (16, 14), 16: (15,),
}

# 17 predefined limb combinations of bone indices fed to BoneRefusion
# (`model/modules/bone_refusion.py:34-40`): six anatomical limbs, five
# limb-vs-spine groups, hands/feet pairs, two cross-coordination groups, and
# two shoulder–hip pairs. Ragged — lengths 2..4.
LIMB_COMBINATIONS = (
    (0, 1, 2), (3, 4, 5), (6, 7), (8, 9), (10, 11, 12), (13, 14, 15),
    (6, 7, 1, 2), (6, 7, 4, 5), (6, 7, 11, 12), (6, 7, 14, 15), (6, 7, 9),
    (14, 15, 11, 12), (1, 2, 4, 5),
    (14, 15, 4, 5), (11, 12, 4, 5),
    (10, 0), (13, 3),
)
MAX_LIMB_COMBINATION = 4

# Left/right joint index lists for horizontal flip augmentation / TTA
# (`utils/utilities.py:128-135`).
LEFT_JOINTS = (4, 5, 6, 11, 12, 13)
RIGHT_JOINTS = (1, 2, 3, 14, 15, 16)


def flip_permutation() -> np.ndarray:
    """Joint permutation applied after negating x to mirror a pose.

    The reference swaps `left_joints+right_joints <- right_joints+left_joints`
    (`utils/utilities.py:134`); expressed here as a single gather permutation
    so a flip is one index op on the joint axis.
    """
    perm = np.arange(NUM_JOINTS)
    # Reference's joint_flip uses left=[1,2,3,14,15,16], right=[4,5,6,11,12,13]
    # (its "left"/"right" naming is swapped relative to JOINT_LABELS; the
    # permutation below reproduces its behavior exactly).
    left = (1, 2, 3, 14, 15, 16)
    right = (4, 5, 6, 11, 12, 13)
    perm[list(left) + list(right)] = list(right) + list(left)
    return perm


FLIP_PERM = flip_permutation()


def spatial_adjacency(num_nodes: int = NUM_JOINTS) -> np.ndarray:
    """Dense 17x17 {0,1} skeleton adjacency (no self-loops), float32."""
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    for i, neighbors in SKELETON_EDGES.items():
        for j in neighbors:
            adj[i, j] = 1.0
    return adj


def temporal_adjacency(num_nodes: int, connection_len: int = 1) -> np.ndarray:
    """Static temporal adjacency: each frame linked to itself and the next
    `connection_len` frames (`model/modules/graph.py:63-75`)."""
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    for i in range(num_nodes):
        for j in range(connection_len + 1):
            if i + j < num_nodes:
                adj[i, i + j] = 1.0
    return adj


def limb_combination_matrix() -> tuple[np.ndarray, np.ndarray]:
    """LIMB_COMBINATIONS as dense (17, 4) index + (17, 4) mask arrays.

    Padding lets the 17 ragged BoneMLPs run as one batched product instead
    of 17 sequential tiny matmuls (cf. the Python loop in the reference's
    `model/modules/bone_refusion.py:63-69`).
    """
    idx = np.zeros((NUM_JOINTS, MAX_LIMB_COMBINATION), dtype=np.int32)
    mask = np.zeros((NUM_JOINTS, MAX_LIMB_COMBINATION), dtype=np.float32)
    for row, combo in enumerate(LIMB_COMBINATIONS):
        idx[row, : len(combo)] = combo
        mask[row, : len(combo)] = 1.0
    return idx, mask
