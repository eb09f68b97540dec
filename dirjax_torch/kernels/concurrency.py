"""Launches of one hand-written kernel from several host threads at once.

Each case alternates two launches of one kernel that need different dynamic
shared memory: K6 resident (m 8 / 64 at ksub 16) and streamed (ksub 256 /
100 at m 32), the ADC rescore (nq 1 / ``rescore_nq`` at m 64, ksub 256),
K1's projection (C 1024 / 2048) and the fused conv (a 3x3 256-channel
convolution on the wgmma path, 201,808 bytes, and a grouped one of 8
channels a group on its 64-channel spans, 185,440); K3, whose size is a
constant of its instantiation, is the control. The threads call the C entry points with
arguments made beforehand, so they meet inside the launchers, where the
shared-memory opt-in is set: a launcher that set the kernel's process-wide
attribute to its own launch's size let another thread lower it in between,
and that launch then failed (cudaErrorInvalidValue, 1).

The card test ``tests/test_torch_kernels.py::TestConcurrentLaunches`` runs
every case at a small size; ``chip_smoke.py``'s "concurrent launches" phase
runs the four shape-dependent ones at serving size.
"""

from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple

import torch

__all__ = ["CASES", "Launch", "alternation", "race"]

CASES = ("k6_resident", "k6_streamed", "rescore", "k1_project", "conv", "k3")


class Launch(NamedTuple):
    label: str
    fn: Callable                 # the C entry point; returns a cudaError_t
    prep: Callable[[], tuple]    # fresh outputs -> (C arguments, result or (result, scratch...))
    want: torch.Tensor           # the plain version's answer
    rtol: float                  # 0 and 0: held to exact equality
    atol: float


def alternation(case: str, device, *, n: int = 4096, nq: int = 64, rescore_nq: int = 256,
                kf: int = 300, head=(8, 8, 8), d: int = 512, seed: int = 0) -> List[Launch]:
    """The two launches of ``case`` over ``n`` rows (K6: ``nq`` queries; the
    rescore: ``kf`` blocks of 64 a query; K1: a (B, H, W) ``head`` map
    projected to ``d``; K3: bf16 at D 256, nq 16 and 256), operands made on
    ``device`` from ``seed``."""
    from ..ops import gem_head, pq, topk
    from .build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    g = torch.Generator(device=device).manual_seed(seed)

    def adc(rows, m, ksub):
        return (torch.randn((rows, m, ksub), generator=g, device=device),
                torch.randint(0, ksub, (n, m), generator=g, device=device, dtype=torch.uint8))

    launches = []
    if case in ("k6_resident", "k6_streamed"):
        for m, ksub in ([(8, 16), (64, 16)] if case == "k6_resident" else [(32, 256), (32, 100)]):
            luts, codes = adc(nq, m, ksub)
            want = pq.adc_finemax_reference(luts, codes, 64)

            def prep(luts=luts, codes=codes, want=want):
                out = torch.empty_like(want)
                return (luts.data_ptr(), 0, codes.data_ptr(), luts.shape[0], n, luts.shape[1],
                        luts.shape[2], 64, out.data_ptr(), stream), out
            launches.append(Launch(f"m={m} ksub={ksub}", lib.dirjax_adc_finemax, prep, want,
                                   0.0, 0.0))
    elif case == "rescore":
        luts, codes = adc(rescore_nq, 64, 256)
        bids = torch.randint(0, n // 64, (rescore_nq, kf), generator=g, device=device)
        for rows in (1, rescore_nq):
            lq, bq = luts[:rows].contiguous(), bids[:rows].contiguous()
            want = pq.adc_gather_scores_reference(lq, codes, bq, 64)

            def prep(lq=lq, bq=bq, want=want):
                out = torch.empty_like(want)
                return (lq.data_ptr(), 0, codes.data_ptr(), bq.data_ptr(), lq.shape[0], n,
                        64, 256, 64, kf, out.data_ptr(), stream), out
            launches.append(Launch(f"nq={rows}", lib.dirjax_adc_gather_scores, prep, want,
                                   0.0, 0.0))
    elif case == "k1_project":
        B, H, W = head
        p = torch.tensor([3.0], device=device)
        for c in (1024, 2048):
            x = torch.rand((B, H, W, c), generator=g, device=device) + 0.05
            weight = torch.randn((d, c), generator=g, device=device) * c ** -0.5
            b = torch.randn((d,), generator=g, device=device) * 0.01
            want = gem_head.gem_head_reference(x, None, p, weight.T, b)

            def prep(x=x, weight=weight, b=b, want=want):
                out = torch.empty_like(want)
                pooled = torch.empty((B, x.shape[3]), device=device)
                counters = torch.empty((-(-B // 8),), dtype=torch.int32, device=device)
                return (x.data_ptr(), 0, None, 0, p.data_ptr(), weight.data_ptr(), b.data_ptr(),
                        pooled.data_ptr(), counters.data_ptr(), out.data_ptr(), B, H * W,
                        x.shape[3], d, 1e-6, stream), (out, pooled, counters)
            launches.append(Launch(f"C={c}", lib.dirjax_gem_head, prep, want, 2e-4, 2e-5))
    elif case == "conv":
        # the kernel sums in another order than its plain version: each
        # launch is held to the kernel's own single-thread answer, exactly,
        # which is first held to the plain version within agreement()'s bounds
        from ..ops import conv

        for cin, groups in ((256, 1), (256, 32)):
            x = torch.randn((2, cin, 17, 13), generator=g, device=device).bfloat16()
            x = x.contiguous(memory_format=torch.channels_last)
            w = torch.randn((256, cin // groups, 3, 3), generator=g, device=device) * \
                (9 * cin / groups) ** -0.5
            scale = torch.rand((256,), generator=g, device=device) + 0.5
            shift = torch.randn((256,), generator=g, device=device) * 0.1
            packed = conv.pack(x, w, 1, 1, groups, scale, shift, relu="post")
            want = conv.run_packed(packed).clone()
            agree = conv.agreement(want, conv.conv_reference(x, w, 1, 1, groups, scale, shift,
                                                             relu="post"),
                                   conv.reference_magnitude(x, w, 1, 1, groups, scale))
            if agree["over"] > 0:
                raise AssertionError(f"conv {cin}/{groups}: the kernel disagrees with its "
                                     f"plain version: {agree}")

            def prep(packed=packed):
                out = torch.empty_like(packed["out"])
                return conv.launch_args(packed, out)[1], out
            launches.append(Launch(f"{conv.kernel_path(cin, 256, groups, 3)} groups={groups}",
                                   lib.dirjax_conv_fused, prep, want.permute(0, 2, 3, 1),
                                   0.0, 0.0))
    elif case == "k3":
        db = torch.nn.functional.normalize(
            torch.randn((n, 256), generator=g, device=device), dim=1).bfloat16()
        for rows in (16, 256):
            q = torch.nn.functional.normalize(
                torch.randn((rows, 256), generator=g, device=device), dim=1).bfloat16()
            want = topk.finemax_reference(q, db, None, 512)

            def prep(q=q, want=want):
                out = torch.empty_like(want)
                return (q.data_ptr(), db.data_ptr(), None, 1, q.shape[0], n, 256, 512,
                        out.data_ptr(), stream), out
            launches.append(Launch(f"nq={rows}", lib.dirjax_finemax, prep, want, 0.0, 1e-5))
    else:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    return launches


def race(launches: List[Launch], threads: int = 8, per_thread: int = 50,
         timeout: float = 120.0) -> float:
    """``threads`` host threads, released together, each making ``per_thread``
    launches that alternate the two of ``launches``. Raises AssertionError if
    a launch fails, a thread does not finish, or an answer is not its plain
    version's (exactly, or within the launch's rtol/atol); returns the
    largest absolute difference."""
    start = threading.Barrier(threads)
    errors, results = [], [[] for _ in range(threads)]

    def work(t):
        try:
            calls = []
            for i in range(per_thread):
                launch = launches[(t + i) % 2]
                args, out = launch.prep()
                calls.append((launch.fn, args))
                results[t].append((launch, out))   # scratch tensors too, alive to the end
            start.wait(timeout=timeout)
            for i, (fn, args) in enumerate(calls):
                err = fn(*args)
                if err != 0:
                    errors.append((t, i, f"cudaError {err}"))
        except Exception as e:   # reported with the launch errors
            errors.append((t, -1, repr(e)))

    pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=2 * timeout)
    if any(th.is_alive() for th in pool):
        raise AssertionError("a launching thread did not finish")
    torch.cuda.synchronize()
    if errors:
        raise AssertionError(f"{len(errors)} of {threads * per_thread} launches failed, e.g. "
                             f"(thread, launch, error) {errors[:4]}")
    worst = 0.0
    for per in results:
        if len(per) != per_thread:
            raise AssertionError(f"a thread made {len(per)} of {per_thread} launches")
        for launch, out in per:
            got = out[0] if isinstance(out, tuple) else out
            if launch.rtol == launch.atol == 0.0:
                if not torch.equal(got, launch.want):
                    raise AssertionError(f"{launch.label}: an answer differs from the plain "
                                         "version")
            else:
                torch.testing.assert_close(got, launch.want, rtol=launch.rtol,
                                           atol=launch.atol, equal_nan=True)
            worst = max(worst, (got - launch.want).abs().max().item())
    return worst
