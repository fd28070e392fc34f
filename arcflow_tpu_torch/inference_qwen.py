"""2-NFE ArcFlow-Qwen-Image inference CLI of the port:

    python -m arcflow_tpu_torch.inference_qwen --model-dir DIR [...]

The root ``inference_qwen.py`` with ``--device``; the flags and folders of
``arcflow_tpu_torch.inference_flux`` without ``--guidance`` (Qwen-Image
has no guidance embeds), the text tower ``PretrainedQwenImageTextEncoder``
(the native Qwen2.5 decoder).
"""

import sys

from arcflow_tpu_torch.inference_flux import main as _main


def main(argv=None):
    return _main(argv, family='qwen')


if __name__ == '__main__':
    sys.exit(main())
