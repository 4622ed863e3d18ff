"""Interactive matplotlib renderer of the port — the reference's figure
layout over the session's views.

Reference layout (``plt_figures``, kspecanal.py:1077-1115): one 16x5
gridspec with the Levels plot (rows 0-7, cols 0-3), the peak-list panel
(col 4), the Heatmap (rows 8-15, cols 0-3), and 8 checkbox-style toggle
Buttons (Levels/HeatMap/Max/Min/Avg/Cur/Pause/Quit, kspecanal.py:1088-1113)
plus a pick handler on the heatmap that prints the clicked frequency
(kspecanal.py:1055-1074).

A copy of ``kspecanal_tpu/gui.py`` with its imports taken from the port
(tests/test_torch_standalone.py holds its code equal to the original's).
The renderer draws only host numpy views (``session.Session._emit`` hands
them over).  The reference's button handlers mutate the shared state mid-
loop; here toggles only write to ``self.toggles``, and the session folds
them into a new frozen config at a step boundary
(``Session._apply_pending_toggles``), which the next device step reads.
matplotlib is imported when a renderer is made, never at import time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.ops.peaks import Peak
from kspecanal_tpu_torch.utils.logging import log_info

CURVE_COLORS = {  # kspecanal.py:491-500: Max r, Min y, Avg g, Cur b
    "max": "r", "min": "y", "avg": "g", "cur": "b",
}


class MatplotlibRenderer:
    """Renderer callback for Session: draws views, owns toggle state."""

    def __init__(self, cfg: SpecConfig, interactive: bool = True,
                 save_dir: str = ""):
        """``save_dir``: write one PNG per rendered frame there instead of
        (or in addition to) showing a window — headless monitoring
        (``tpuRenderer png:<dir>``)."""
        import matplotlib
        if not interactive:
            matplotlib.use("Agg")
        self.interactive = interactive
        self.save_dir = save_dir
        if save_dir:
            import os
            os.makedirs(save_dir, exist_ok=True)
        import matplotlib.pyplot as plt
        self.plt = plt
        self.cfg = cfg
        self.toggles = {
            "b_plt_levels": cfg.b_plt_levels,
            "b_plt_heatmap": cfg.b_plt_heatmap,
            "b_data_max": cfg.b_data_max,
            "b_data_min": cfg.b_data_min,
            "b_data_avg": cfg.b_data_avg,
            "b_data_cur": cfg.b_data_cur,
            "plt_highs_pause": cfg.plt_highs_pause,
        }
        self.quit_requested = False
        self._hm_image = None
        self._buttons = {}
        if interactive:
            plt.ion()
        self._build_figure()

    # -- figure construction (kspecanal.py:1077-1115) --------------------
    def _build_figure(self):
        plt = self.plt
        f = self.fig = plt.figure("kSpecAnal-TPU", figsize=(12, 8),
                                  constrained_layout=True)
        gs = f.add_gridspec(nrows=16, ncols=5)
        self.ax_levels = f.add_subplot(gs[:8, :4])
        self.ax_freqs = f.add_subplot(gs[:8, 4])
        self.ax_freqs.set_xlabel("Freqs - HighSigLvl")
        self.ax_freqs.set_xticks([])
        self.ax_freqs.set_yticks([])
        self.ax_heatmap = f.add_subplot(gs[8:16, :4])
        btn_rows = {
            "Levels": (8, "b_plt_levels"),
            "HeatMap": (9, "b_plt_heatmap"),
            "MaxLvls": (10, "b_data_max"),
            "MinLvls": (11, "b_data_min"),
            "AvgLvls": (12, "b_data_avg"),
            "CurLvls": (13, "b_data_cur"),
            "Pause": (14, "plt_highs_pause"),
        }
        for name, (row, key) in btn_rows.items():
            ax = f.add_subplot(gs[row, 4])
            btn = plt.Button(ax, name)
            btn.on_clicked(self._make_toggle(name, key))
            self._buttons[name] = btn
        ax_quit = f.add_subplot(gs[15, 4])
        self._buttons["Quit"] = plt.Button(ax_quit, "Quit")
        self._buttons["Quit"].on_clicked(self._on_quit)
        f.canvas.mpl_connect("pick_event", self._on_pick)
        self._update_button_labels()

    def _make_toggle(self, name, key):
        def handler(event):
            self.toggles[key] = not self.toggles[key]
            # at-least-one-curve invariant (kspecanal.py:983-984)
            if not any(self.toggles[k] for k in
                       ("b_data_min", "b_data_max", "b_data_avg",
                        "b_data_cur")):
                self.toggles["b_data_avg"] = True
            self._update_button_labels()
        return handler

    def _update_button_labels(self):
        # checkbox-style labels (kspecanal.py:975-991)
        for name, key in (("Levels", "b_plt_levels"),
                          ("HeatMap", "b_plt_heatmap"),
                          ("MaxLvls", "b_data_max"),
                          ("MinLvls", "b_data_min"),
                          ("AvgLvls", "b_data_avg"),
                          ("CurLvls", "b_data_cur"),
                          ("Pause", "plt_highs_pause")):
            mark = "x" if self.toggles[key] else " "
            self._buttons[name].label.set_text(f"{name}[{mark}]")

    def _on_quit(self, event):
        self._buttons["Quit"].label.set_text("QuitWait")
        self.quit_requested = True

    def _on_pick(self, event):
        """Heatmap click -> frequency readout (kspecanal.py:1055-1074)."""
        me = event.mouseevent
        if me.xdata is None:
            return
        cfg = self.cfg
        freq = cfg.start_freq + (cfg.end_freq - cfg.start_freq) * me.xdata
        log_info(f"PickEvent:HeatMap:Freq: {freq}")
        self.ax_heatmap.set_xlabel(f"Freqs [ClickedFreq:{freq}]")

    # -- per-frame render -------------------------------------------------
    def apply_toggles(self, cfg: SpecConfig) -> SpecConfig:
        """Fold pending GUI toggles into a new frozen config (applied by
        the session at a step boundary)."""
        return dataclasses.replace(cfg, **{
            k: v for k, v in self.toggles.items() if hasattr(cfg, k)})

    def __call__(self, sess, view, peaks: List[Peak], iteration: int,
                 timestamp_str: Optional[str]):
        if self.quit_requested:
            sess.stop = True
            return
        x = np.asarray(view.x_freqs)
        if self.toggles["b_plt_levels"]:
            ax = self.ax_levels
            ax.cla()
            if self.cfg.b_grid:
                ax.grid(True)
            for key, color in CURVE_COLORS.items():
                if self.toggles[f"b_data_{key}"]:
                    y = np.asarray(getattr(view, f"{key}_lvls"))
                    ax.plot(x[: len(y)], y, color)
            if timestamp_str:
                ax.set_xlabel(timestamp_str)
            self._draw_peaks(peaks)
        if self.toggles["b_plt_heatmap"]:
            hm = np.asarray(view.heatmap)
            if self._hm_image is None:
                cfg = self.cfg
                self._hm_image = self.ax_heatmap.imshow(
                    hm, extent=(0, 1, 0, 1), aspect="auto",
                    interpolation="bicubic", picker=True)
                f25 = cfg.start_freq + (cfg.center_freq - cfg.start_freq) / 2
                f75 = cfg.center_freq + (cfg.end_freq - cfg.center_freq) / 2
                self.ax_heatmap.set_xticks([0, 0.25, 0.5, 0.75, 1])
                self.ax_heatmap.set_xticklabels(
                    [cfg.start_freq, f25, cfg.center_freq, f75, cfg.end_freq])
                self.ax_heatmap.set_xlabel("Freqs")
                self.ax_heatmap.set_ylabel("ScanHistory")
            else:
                self._hm_image.set_data(hm)
                self._hm_image.autoscale()
        self.plt.draw()
        if self.save_dir:
            import os
            self.fig.savefig(os.path.join(self.save_dir,
                                          f"frame_{iteration:06d}.png"),
                             dpi=80)
        self.plt.pause(0.0001)
        if self.toggles["plt_highs_pause"]:
            self._prompt("PltHighsPause: Press any key to continue...")

    @staticmethod
    def _prompt(msg: str):
        """Interactive holds prompt only on a real TTY: a scripted run's
        silent (non-EOF) stdin would otherwise block forever, holding the
        device after a completed session."""
        import sys
        if not sys.stdin.isatty():
            return
        try:
            input(msg)
        except EOFError:   # piped stdin: don't wedge scripted runs
            pass

    def _draw_peaks(self, peaks: List[Peak]):
        """Peak markers + side panel (plot_highs, kspecanal.py:243-272)."""
        self.ax_freqs.clear()
        self.ax_freqs.set_xlabel("Freqs[MHz] - HighSigLvl")
        self.ax_freqs.set_xticks([])
        self.ax_freqs.set_yticks([])
        for i, p in enumerate(peaks):
            self.ax_levels.plot(p.freq, p.level, "o", label=p.freq)
            self.ax_freqs.text(0.1, 1.0 - 0.1 * (i + 1),
                               f"{round(p.freq / 1e6, 8)}:{round(p.level, 2)}")
        if peaks:
            self.ax_levels.legend()

    def hold_until_key(self):
        """End-of-run hold: keep the figure up until a keypress
        (kspecanal.py:1152-1155, incl. the Quit-button relabel)."""
        self._buttons["Quit"].label.set_text("QuitPress")
        self.plt.draw()
        self.plt.pause(0.0001)
        self._prompt("Press any key to quit...")

    def close(self):
        self.plt.close(self.fig)
