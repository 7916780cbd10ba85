"""Device ms a call of the program's ``embed.encoder`` span: the encoder
and the pooling."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "embed.encoder")
