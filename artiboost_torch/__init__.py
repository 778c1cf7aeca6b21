"""PyTorch/CUDA port of ArtiBoost's synthesis-and-mining loop.

Mirrors the layout of ``artiboost_tpu`` (the JAX reference, which this
package never imports): ``artiboost/`` (CCV space, pose generation,
rendering, mining, the loader), ``mano/``, ``models/``, ``ops/`` (the
rasterizer and its hand-written CUDA kernel under ``csrc/``),
``metrics/``, ``postprocess/`` (IKNet and the MANO fitting unit),
``submit/`` (the Codalab pass), ``viztools/`` and ``utils/``. Entry points:
``python -m artiboost_torch.train`` and ``python -m artiboost_torch.submit_reload``.

Conventions: images are NHWC at public functions; every function that
draws randomness is split into a ``*_draws(generator, ...)`` half and a
deterministic half that consumes the draws; entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
