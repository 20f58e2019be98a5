"""I/O of the port: the PLY, STL and PNG codecs (numpy), captured frames
(``images``), the ``.mat`` calibration (``matcal``) and the session layout
(``layout``), with the JAX package's package-level names."""

from .images import (  # noqa: F401
    device_stack,
    list_frames,
    load_stack,
    load_white_rgb,
    numeric_sort,
    write_frame,
)
from .layout import SessionLayout, frame_name, list_clouds  # noqa: F401
from .matcal import load_calibration_mat, save_calibration_mat  # noqa: F401
from .ply import PointCloud, read_ply, write_ply  # noqa: F401
from .png import decode_png, png_bytes, write_png  # noqa: F401
from .stl import TriangleMesh, read_stl, write_stl  # noqa: F401
