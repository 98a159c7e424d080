"""The benchmark of the PyTorch and CUDA port
(``egomotion_with_local_loop_closures_tpu_torch``): one command,
``python ellc_bench/run.py``, driven by the files under this folder.
It imports neither JAX nor the JAX package."""
