"""Transform chain visualizer (the port's copy of ``dirjax/data/__main__.py``,
which it mirrors) — working replacement for the reference's
``transforms.py`` debug main (transforms.py:705-763): apply a chain to an
image and save/describe the results.

    python -m dirjax_torch.data "RandomScale(64,128), RandomFlip()" in.jpg out.jpg [n]
"""

import sys

from PIL import Image

from . import transforms as T

if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    chain_str, in_path = sys.argv[1], sys.argv[2]
    out_path = sys.argv[3] if len(sys.argv) > 3 else None
    n = int(sys.argv[4]) if len(sys.argv) > 4 else 1

    chain = T.create(chain_str)
    img = Image.open(in_path).convert("RGB")
    print(f"input:  {in_path} {img.size}")
    for i in range(n):
        out = chain({"img": img.copy()})["img"]
        print(f"sample {i}: size={out.size}")
        if out_path:
            path = (out_path if n == 1 else
                    out_path.replace(".", f"_{i}.", 1))
            out.save(path)
            print(f"  saved {path}")
