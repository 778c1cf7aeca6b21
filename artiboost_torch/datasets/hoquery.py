"""Sample-dict key schema (parity: ``anakin/datasets/hoquery.py``).

Batches in this framework are plain dicts of arrays keyed by these
constants; fixed shapes + padding masks keep everything jit-compatible.
"""


class Queries:
    SAMPLE_IDX = "sample_idx"
    RAW_IMAGE = "raw_image"
    IMAGE = "image"
    IMAGE_PATH = "image_path"
    CAM_INTR = "cam_intr"
    ORTHO_INTR = "ortho_intr"

    OBJ_VERTS_CAN = "obj_verts_can"
    OBJ_VERTS_3D = "obj_verts_3d"
    OBJ_VERTS_2D = "obj_verts_2d"
    HAND_VERTS_3D = "hand_verts_3d"
    HAND_VERTS_2D = "hand_verts_2d"

    CORNERS_CAN = "corners_can"
    CORNERS_2D = "corners_2d"
    CORNERS_3D = "corners_3d"
    JOINTS_2D = "joints_2d"
    JOINTS_3D = "joints_3d"
    ROOT_JOINT = "root_joint"
    BONE_SCALE = "bone_scale"

    JOINTS_HEATMAP = "joints_heatmap"
    CORNERS_HEATMAP = "corners_heatmap"

    CORNERS_VIS = "corners_vis"
    JOINTS_VIS = "joints_vis"

    OBJ_TRANSF = "obj_transf"
    OBJ_FACES = "obj_faces"
    HAND_SHAPE = "hand_shape"
    HAND_POSE = "hand_pose"
    HAND_FACES = "hand_faces"

    BBOX_CENTER = "bbox_center"
    BBOX_SCALE = "bbox_scale"

    HAND_BBOX = "hand_bbox"

    OBJ_IDX = "obj_idx"

    SIDE = "side"
    PADDING_MASK = "padding_mask"
    FACE_PADDING_MASK = "face_padding_mask"

    # TPU addition (no reference counterpart): (B,) 1/0 mask marking rows
    # that are real samples vs repeat-padding added to keep the final
    # batch's shape static for jit. Metrics and the Codalab dump honor it.
    SAMPLE_VALID = "sample_valid"


class SynthQueries:
    IS_SYNTH = "is_synth"
    OBJ_ID = "obj_id"
    PERSP_ID = "persp_id"
    GRASP_ID = "grasp_id"
