"""Mean host us a request spends in the IndexServer's front in the traced
slice: program span ``server.parse`` (the frame after its length, the
decode, the submit) plus ``server.reply`` (the bytes and the send)."""

from harness.program_spans import front_us as read  # noqa: F401
