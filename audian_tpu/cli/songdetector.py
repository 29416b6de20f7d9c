"""``audian-songdetector``: batch song detection in recordings.

CLI rebuild of the reference's standalone ``songdetector.py:684-771``:
ConfigFile-driven parameters (same option names, units and doc strings,
cascade-loaded from the data directories, dumpable with
``-c/--save-config``), the same processing pipeline — band-pass ->
squared envelope -> histogram thresholds -> detection -> per-event
envelope-frequency refinement — with the dense DSP on the device, and
data-parallel over multiple input files.  Events are written to a CSV
table (and optionally plotted to PNG; the reference's interactive
matplotlib viewer lives in :mod:`audian_tpu.gui.songplot`).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

from ..version import __version__
from ..config import ConfigFile
from ..analysis.events import detect
from ..analysis.table import ResultTable


def default_config():
    """The reference's configuration (`songdetector.py:703-731`)."""
    cfg = ConfigFile()
    cfg.add_section("Plotting:")
    cfg.add("maxpixel", 50000, "", "Either maximum number of data points to"
            " be plotted or zero for plotting all data points.")
    cfg.add_section("Filter:")
    cfg.add("highpassfreq", 1000.0, "Hz", "Cutoff frequency of the high-pass"
            " filter applied to the signal.")
    cfg.add("lowpassfreq", 10000.0, "Hz", "Cutoff frequency of the low-pass"
            " filter applied to the signal.")
    cfg.add_section("Envelope:")
    cfg.add("envelopecutofffreq", 500.0, "Hz", "Cutoff frequency of the"
            " low-pass filter used for computing the envelope from the"
            " squared signal.")
    cfg.add("envelopepeakthresh", 10.0, "dB", "Minimum required height of"
            " peak in envelope.")
    cfg.add("envelopefilter", "apply", "", "Apply lowpass filter to envelope"
            " with cutoff determined from main peak in envelope spectrum for"
            " each event (apply), filter envelopes with the average peak"
            " frequency (average), or do not filter envelope (none).")
    cfg.add_section("Thresholds:")
    cfg.add("thresholdfactor", 8.0, "", "Factor that multiplies the standard"
            " deviation of the whole envelope.")
    cfg.add("minthreshfac", 1.0, "", "In the final analysis the local"
            " threshold must be larger than this factor times the global"
            " threshold.")
    cfg.add_section("Detection:")
    cfg.add("minduration", 0.5, "s", "Minimum duration of an detected song.")
    return cfg


def main(cargs=None):
    prog = Path(sys.argv[0]).stem or "songdetector"
    cfgfile = prog + ".cfg"
    parser = argparse.ArgumentParser(
        description="Detect songs in multitrace time series data.",
        epilog=f"audian-tpu {__version__}",
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("-v", action="count", dest="verbose", default=0,
                        help="print debug information")
    parser.add_argument("-c", "--save-config", nargs="?", default="",
                        const=cfgfile, type=str, metavar="cfgfile",
                        help="save configuration to file cfgfile "
                        f"(defaults to {cfgfile})")
    parser.add_argument("-o", dest="output", default=None, type=str,
                        help="write detected events to this CSV file "
                        "(default: <file>-songs.csv)")
    parser.add_argument("-p", "--plot", action="store_true",
                        help="open the interactive viewer (the reference's "
                        "SignalPlot) for each file")
    parser.add_argument("--plot-png", dest="plot_png", default=None,
                        metavar="FILE", type=str,
                        help="render the viewer to a PNG (headless)")
    parser.add_argument("-j", dest="jobs", default=1, type=int,
                        metavar="N",
                        help="process files data-parallel across devices "
                        "(N workers; 0 means one per device)")
    parser.add_argument("--mesh", dest="mesh", default=1, type=int,
                        metavar="N",
                        help="shard each recording's time axis over N "
                        "devices (0 means all; halos exchanged between "
                        "devices) "
                        "— for recordings much longer than one device's "
                        "memory; combines with -j only trivially (use "
                        "one or the other)")
    parser.add_argument("files", nargs="*", default=[], type=str,
                        help="files with the time series data")
    args = parser.parse_args(cargs)

    cfg = default_config()
    if args.files:
        cfg.load_files(cfgfile, args.files[0], 3, args.verbose)
    if args.save_config:
        if not args.save_config.endswith(".cfg"):
            print("configuration file name must have .cfg as extension!")
            return 1
        print(f"write configuration to {args.save_config} ...")
        cfg.dump(args.save_config)
        return 0
    if not args.files:
        parser.error("no input files")

    mesh = None
    if args.mesh != 1:
        if args.plot or args.plot_png:
            # the viewer needs the full-rate filtered stream, which the
            # sharded path never materializes — say so, like -j does
            print("--mesh is ignored with --plot/--plot-png "
                  "(the viewer needs the unsharded filtered stream)",
                  file=sys.stderr)
        else:
            import jax
            from jax.sharding import Mesh

            devs = jax.devices()
            ndev = (len(devs) if args.mesh == 0
                    else min(args.mesh, len(devs)))
            if ndev > 1:
                mesh = Mesh(np.array(devs[:ndev]).reshape(ndev),
                            ("seq",))
                if args.verbose:
                    print(f"sequence-sharding over {ndev} devices")
            else:
                print(f"--mesh {args.mesh}: only {len(devs)} device(s) "
                      "available, running single-device",
                      file=sys.stderr)

    def process(path):
        """Detect songs in one file; returns (path, nsongs, out) or the
        error message.  Dense DSP runs on the worker's device.

        PCM-16 recordings load as raw int16 (no float decode, half the
        host memory and device-link bytes; ``detect`` dequantizes on
        device); other encodings decode to float."""
        try:
            from ..data.loader import AudioLoader

            ld = AudioLoader(path, prefetch=False)
            rate = ld.rate
            if ld.raw16_capable:
                data = np.empty((ld.frames, ld.channels), np.int16)
                ld.read_raw16_into(0, ld.frames, data)
            else:
                # decode through the already-open loader — a separate
                # load_audio() would re-open and re-scan the file
                data = np.empty((ld.frames, ld.channels), np.float32)
                ld._read_into(0, ld.frames, data)
            ld.close()
        except Exception as e:
            return f"{path}: {e}"
        if args.verbose:
            print(f"loaded {path} ({data.shape[0]} frames @ {rate:.0f} Hz)",
                  flush=True)
        result = detect(
            data, rate,
            highpassfreq=cfg.value("highpassfreq"),
            lowpassfreq=cfg.value("lowpassfreq"),
            envelopecutofffreq=cfg.value("envelopecutofffreq"),
            envelopepeakthresh=cfg.value("envelopepeakthresh"),
            envelopefilter=cfg.value("envelopefilter"),
            thresholdfactor=cfg.value("thresholdfactor"),
            minthreshfac=cfg.value("minthreshfac"),
            minduration=cfg.value("minduration"),
            verbose=args.verbose,
            # only the viewer plots the full-rate filtered stream; batch
            # runs skip pulling it from the device
            return_filtered=bool(args.plot or args.plot_png),
            mesh=mesh,
        )
        table = ResultTable()
        table.append("channel", "", "%.0f")
        table.append("tstart", "s", "%.4f")
        table.append("tend", "s", "%.4f")
        table.append("duration", "s", "%.4f")
        nsongs = 0
        for c, (ons, offs) in enumerate(zip(result["onsets"],
                                            result["offsets"])):
            for t0, t1 in zip(ons, offs):
                table.add([c, t0, t1, t1 - t0])
                nsongs += 1
        out = args.output or Path(path).with_suffix("").as_posix() + "-songs.csv"
        table.write(out)
        if args.plot or args.plot_png:
            from ..gui.songplot import SongPlot

            win = SongPlot(data, rate, result, cfg=cfg, filename=path)
            if args.plot_png:
                win.savefig(args.plot_png)
                print(f"saved viewer figure to {args.plot_png}")
            if args.plot:
                import matplotlib.pyplot as plt

                plt.show()
        return (path, nsongs, out)

    status = 0
    jobs = args.jobs
    if jobs != 1 and (args.plot or args.plot_png):
        print("-j ignored with --plot/--plot-png (matplotlib is "
              "single-threaded)", file=sys.stderr)
        jobs = 1
    if args.output and len(args.files) > 1:
        parser.error("-o names ONE output file but multiple inputs were "
                     "given (each would overwrite it); drop -o to get "
                     "per-file <stem>-songs.csv tables")
    if jobs == 1 or len(args.files) <= 1:
        results = [process(p) for p in args.files]
    else:
        # data-parallel across devices: one recording per chip
        # (BASELINE config 5 — the multi-chip analog of the reference's
        # per-file worker pool)
        from ..parallel import map_files

        results = map_files(process, args.files,
                            max_workers=(jobs if jobs > 0 else None),
                            verbose=args.verbose)
    for r in results:
        if isinstance(r, str):
            print(f"error: {r}", file=sys.stderr)
            status = 1
        else:
            path, nsongs, out = r
            print(f"{path}: {nsongs} songs -> {out}")
    return status


def run():
    return main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(run())
