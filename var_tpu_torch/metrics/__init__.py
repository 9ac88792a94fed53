"""Quality metrics (counterpart of ``var_tpu/metrics``): the Fréchet distance
scorer of ``fid.py``."""
