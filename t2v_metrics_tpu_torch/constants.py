"""Constants of the port (a copy of those it uses from
t2v_metrics_tpu/constants.py, under the same names).

The LLaVA/CLIP-FlanT5 prompt constants are part of the scoring contract:
prompts are spliced on DEFAULT_IMAGE_TOKEN and image placeholder positions
use IMAGE_TOKEN_INDEX.
"""

import os

# the last local cache searched for pretrained snapshots
# (models/checkpoint.py:hub_cache_dirs); nothing is ever downloaded into it
HF_CACHE_DIR = os.environ.get("T2V_TPU_CACHE", "./hf_cache/")

SYSTEM_MSG = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"

# Default VQAScore templates
DEFAULT_QUESTION_TEMPLATE = 'Does this figure show "{}"? Please answer yes or no.'
DEFAULT_ANSWER_TEMPLATE = "Yes"

# Preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

# Video file extensions routed through the video path
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
