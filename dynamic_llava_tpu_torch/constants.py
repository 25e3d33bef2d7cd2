"""Model and data sentinels (the port's own copy of the values in
``dynamic_llava_tpu/constants.py``). The values are contract: they are
baked into trained checkpoints and preprocessed datasets."""

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
