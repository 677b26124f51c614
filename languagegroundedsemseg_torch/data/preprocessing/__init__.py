"""Offline preprocessing scripts (counterpart of
``languagegroundedsemseg_tpu/data/preprocessing/``): numpy, the port's
PLY IO and its CPU furthest-point sampling."""
