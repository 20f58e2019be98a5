"""I/O of the port: the PLY, STL and PNG codecs (numpy), captured frames
(``images``), the ``.mat`` calibration (``matcal``) and the session layout
(``layout``)."""
