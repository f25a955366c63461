from jpgenc_tpu_torch.container.jfif import build_headers  # noqa: F401
from jpgenc_tpu_torch.container.parser import parse_jpeg  # noqa: F401
