// Vanilla-JS live dashboard client (parity: reference web_dashboard/app.js:
// connection badge, per-frame stats, canvas trajectory from x/z positions).
(function () {
  const statusEl = document.getElementById("status");
  const canvas = document.getElementById("trajectory");
  const ctx = canvas.getContext("2d");

  function setText(id, value) {
    document.getElementById(id).textContent = value;
  }

  function drawTrajectory(points) {
    ctx.clearRect(0, 0, canvas.width, canvas.height);
    if (!points || points.length < 2) return;
    let minX = Infinity, maxX = -Infinity, minZ = Infinity, maxZ = -Infinity;
    for (const [x, z] of points) {
      minX = Math.min(minX, x); maxX = Math.max(maxX, x);
      minZ = Math.min(minZ, z); maxZ = Math.max(maxZ, z);
    }
    const pad = 20;
    const spanX = Math.max(maxX - minX, 1e-6);
    const spanZ = Math.max(maxZ - minZ, 1e-6);
    const scale = Math.min((canvas.width - 2 * pad) / spanX, (canvas.height - 2 * pad) / spanZ);
    const toPx = ([x, z]) => [
      pad + (x - minX) * scale,
      canvas.height - pad - (z - minZ) * scale,
    ];
    ctx.strokeStyle = "#4ea1ff";
    ctx.lineWidth = 2;
    ctx.beginPath();
    const [x0, y0] = toPx(points[0]);
    ctx.moveTo(x0, y0);
    for (const p of points.slice(1)) {
      const [x, y] = toPx(p);
      ctx.lineTo(x, y);
    }
    ctx.stroke();
    const [cx, cy] = toPx(points[points.length - 1]);
    ctx.fillStyle = "#ff5e5e";
    ctx.beginPath();
    ctx.arc(cx, cy, 4, 0, 2 * Math.PI);
    ctx.fill();
  }

  function connect() {
    const ws = new WebSocket(`ws://${location.hostname}:8000`);
    ws.onopen = () => {
      statusEl.textContent = "connected";
      statusEl.className = "badge connected";
    };
    ws.onclose = () => {
      statusEl.textContent = "disconnected";
      statusEl.className = "badge disconnected";
      setTimeout(connect, 1000);
    };
    ws.onmessage = (event) => {
      const msg = JSON.parse(event.data);
      setText("frame", msg.frame_id);
      setText("progress", `${Math.round(msg.progress * 100)}%`);
      setText("features", msg.num_features);
      setText("matches", msg.num_matches);
      setText("inliers", msg.num_inliers);
      setText("ratio", msg.inlier_ratio.toFixed(3));
      setText("model", msg.model_type || "–");
      setText("tracking", msg.pose_success ? "OK" : "LOST");
      drawTrajectory(msg.trajectory);
    };
  }
  connect();
})();
