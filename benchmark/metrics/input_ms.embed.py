"""Device ms a call of the program's ``embed.input`` span: the batch to the
card, the mel, the chunks."""
from harness import spans


def read(out):
    return spans.phase_ms(out, "embed.input")
