"""Where the datasets, the logs and the weights live.

Port of `upliftingtabletennis_tpu/paths.py`: three module globals resolved from
environment variables, with defaults under the working directory. Every CLI also takes
explicit path arguments; the globals serve scripts in the reference's import-and-use style.

  UTT_DATA_PATH     the datasets' root (tthq/, blurball/, ttst/, syntheticdata/)
  UTT_LOGS_PATH     TensorBoard runs and saved models
  UTT_WEIGHTS_PATH  released or converted checkpoints
"""
import os

data_path = os.environ.get("UTT_DATA_PATH", os.path.join(os.getcwd(), "data"))
logs_path = os.environ.get("UTT_LOGS_PATH", os.path.join(os.getcwd(), "runs"))
weights_path = os.environ.get("UTT_WEIGHTS_PATH", os.path.join(os.getcwd(), "weights"))
