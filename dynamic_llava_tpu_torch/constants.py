"""Model, data and serving constants (the port's own copy of the values in
``dynamic_llava_tpu/constants.py``). The sentinel values are contract: they
are baked into trained checkpoints and preprocessed datasets."""

# seconds without a heartbeat before the controller drops a worker
CONTROLLER_HEART_BEAT_EXPIRATION = 30
# seconds between worker heartbeat posts
WORKER_HEART_BEAT_INTERVAL = 15

# directory for rotating serving logs (``utils.build_logger``)
LOGDIR = "."

# label value excluded from the LM loss (HF convention)
IGNORE_INDEX = -100
# sentinel token id marking where image features splice into the sequence
IMAGE_TOKEN_INDEX = -200

# prompt-side image markers
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
