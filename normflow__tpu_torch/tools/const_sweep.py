#!/usr/bin/env python3
"""Device times of edited copies of a kernel's compile-time constants::

    python3 normflow__tpu_torch/tools/const_sweep.py CHECKOUT WORKDIR SOURCE \\
        CASES SPEC [SPEC ...]

``SOURCE`` names a file of ``normflow__tpu_torch/csrc/`` (for example
``rqs_coupling.cu``), ``CASES`` a regular expression of
``kernel_times.py``'s cases to time, and each ``SPEC`` some of the
source's ``constexpr`` constants, ``NAME=VALUE,NAME=VALUE`` (``base``
keeps the checkout's values).  For each distinct ``SPEC`` the tool copies
the port of ``CHECKOUT`` into ``WORKDIR/<SPEC>/``, sets those constants,
builds every copy at once, and then runs ``kernel_times.py`` on the copies
one after another in the order given, so a spec repeated (``A B B A``)
times the two in turns on one card.  Each copy's lines start with its
spec; before them, the registers and spill bytes ptxas gave every instance
of the source's device functions at m = 8 with linear tails, the
flagship's (every instance of a source with no coupling kernel, such as
``phi4_action.cu``).  ``WORKDIR`` (a git-ignored directory such as
``_chipcheck/``) keeps the copies and each run's outputs.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_INSTANCE = "ILi8ELb1ELb1E"


def edit(text, spec):
    """``text`` with each ``constexpr <type> NAME = ...;`` of ``spec`` set
    to its value; raises for a name the source does not define."""
    for item in filter(None, spec.split(",")):
        if item == "base":
            continue
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{name} is not one constexpr of the source")
    return text


def registers(log, source):
    """``(device function instance, registers, spill store bytes)`` of the
    flagship's instances that ptxas compiled from ``source`` (every
    instance, for a source with no coupling kernel)."""
    unit = "_" + source.replace(".", "_") + "_"
    rows, inst, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst and unit in inst and (
                FLAGSHIP_INSTANCE in inst or "rqs" not in source):
            rows.append((inst, int(m.group(1)), spill))
    return rows


def main(checkout, workdir, source, cases, *specs):
    checkout, workdir = os.path.abspath(checkout), os.path.abspath(workdir)
    dirs = {}
    for spec in dict.fromkeys(specs):
        d = os.path.join(workdir, re.sub(r"[^\w=,.-]", "_", spec))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(checkout, "normflow__tpu_torch"),
                        os.path.join(d, "normflow__tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = os.path.join(d, "normflow__tpu_torch", "csrc", source)
        with open(src) as f:
            text = f.read()
        with open(src, "w") as f:
            f.write(edit(text, spec))
        dirs[spec] = d
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from "
             "normflow__tpu_torch.ops.kernels import _lib; _lib.library(); "
             "print(_lib.build_info['log'])")
    procs = {spec: subprocess.Popen([sys.executable, "-c", build, d],
                                    stdout=subprocess.PIPE, text=True)
             for spec, d in dirs.items()}
    for spec, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{spec}: the build failed")
        with open(out.strip().splitlines()[-1]) as f:
            for inst, regs, spill in registers(f.read(), source):
                print(f"{spec}: ptxas {inst}: {regs} registers, {spill} "
                      "bytes spilled", flush=True)
    for k, spec in enumerate(specs):
        subprocess.run([sys.executable, os.path.join(TOOLS, "kernel_times.py"),
                        dirs[spec], spec,
                        os.path.join(workdir, f"{k}.pt"), cases], check=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
