"""matplotlib for ``--savePlots``, imported only when plots are asked for."""


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend.

    matplotlib is not a dependency of the package: a run that does not save
    plots never imports it, and one that does fails here with a clear
    message if it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "--savePlots / save_plots=True needs matplotlib, which is not "
            "installed; install it or run without saving plots") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
