"""``audian``: browse and analyze recordings of animal vocalizations.

The reference-compatible main entry (`src/audian/audian.py:1467-1544`):
loads user plugins from the working directory, parses the CLI, opens the
recordings, and starts a GUI frontend — Qt/pyqtgraph when available,
matplotlib otherwise.  ``--screenshot`` renders the initial view headless
(Agg) and exits, which doubles as the scriptable smoke test; a screenshot
saved by the GUI can be passed back as the input file to restore its view
(`audian.py:232-260`).
"""

from __future__ import annotations

import sys
from ..analysis import Plugins
from ..app.shell import audian_cli
from ..app.screenshot import parse_view_metadata


def _pop_option(argv, name, has_value=True):
    """Pop ``name`` (and its value) from argv, accepting both
    ``--opt value`` and ``--opt=value`` forms."""
    for i, arg in enumerate(argv):
        if has_value and arg.startswith(name + "="):
            argv.pop(i)
            return arg[len(name) + 1:]
        if arg == name:
            argv.pop(i)
            if not has_value:
                return True
            # a following token is the value unless it is clearly
            # another long option — filenames like "-shot.png" are
            # legitimate values and must not trip the missing-value path
            if i < len(argv) and not argv[i].startswith("--"):
                return argv.pop(i)
            print(f"error: {name} needs a value", file=sys.stderr)
            return None
    return None if has_value else False


def main(cargs=None):
    argv = list(sys.argv[1:] if cargs is None else cargs)
    screenshot = _pop_option(argv, "--screenshot")
    use_mpl = bool(_pop_option(argv, "--mpl", has_value=False))

    plugins = Plugins()
    plugins.load_plugins(verbose=True)

    shell = audian_cli(argv, plugins)

    # screenshots restore their recorded view (view checkpoints); a
    # missing/corrupt PNG falls through as a (failing) normal input
    # instead of crashing before any recording opens
    restores = {}
    for k, f in enumerate(list(shell._pending)):
        if str(f).lower().endswith(".png"):
            try:
                view = parse_view_metadata(f)
            except Exception as e:
                print(f"cannot read view from {f}: {e}", file=sys.stderr)
                view = None
            if view is not None:
                shell._pending[k] = view["file"]
                restores[str(view["file"])] = view

    import audian_tpu

    audian_tpu.enable_compilation_cache()

    # apply view restores as each browser comes up — works for both the
    # eager mpl/screenshot path and the progressive Qt path.  Inside the
    # dispatch guard: a restore must not fan its view through the link
    # dispatch onto the other restored browsers.
    def apply_restore(b):
        view = restores.get(str(b.file_path))
        if view:
            def apply():
                if view["channels"]:
                    b.set_channels(view["channels"])
                b.set_times(view["toffset"], view["twindow"])
            shell._dispatch(apply)

    shell.sigBrowserAdded.connect(apply_restore)

    run_qt = None
    if not use_mpl and not screenshot:
        # gui.qt always imports — it guards its own Qt imports and
        # reports their absence through HAVE_QT
        from ..gui import qt as qt_gui

        if qt_gui.HAVE_QT:
            run_qt = qt_gui.run_qt
    if run_qt is not None:
        # open only the first recording before the window shows; the
        # window pumps the rest one per event-loop tick
        # (`audian.py:1339-1407`)
        while shell.pending and not shell.browsers:
            shell.load_next()
        for path, err in shell.errors:
            print(f"failed to open {path}: {err}", file=sys.stderr)
        if not shell.browsers:
            print("error: no recordings could be opened", file=sys.stderr)
            return 1
        # background-compile the NFFT sweep so the first resolution
        # keypress never waits on its compiles
        shell.current.warm_resolutions_async()
        return run_qt(shell)

    shell.load_files()
    # the reference reports every failed file (`audian.py:1349-1352`)
    for path, err in shell.errors:
        print(f"failed to open {path}: {err}", file=sys.stderr)
    if not shell.browsers:
        print("error: no recordings could be opened", file=sys.stderr)
        return 1

    if screenshot:
        import matplotlib

        matplotlib.use("Agg")
        from ..gui.mpl import MplBrowserWindow

        win = MplBrowserWindow(shell.browsers[0])
        win.savefig(screenshot)
        print(f"saved screenshot to {screenshot}")
        shell.close()
        return 0

    from ..gui.mpl import show

    # see the Qt path: warm the NFFT sweep off the first keypress
    shell.current.warm_resolutions_async()
    show(shell)
    shell.close()
    return 0


def run():
    return main()


if __name__ == "__main__":
    sys.exit(run())
