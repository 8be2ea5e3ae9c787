from . import agreement, wer
