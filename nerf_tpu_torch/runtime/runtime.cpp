// The port's host runtime: the part of the JAX package's native runtime
// (nerf_tpu/runtime/runtime.cpp, sections 2 and 3) that the streaming
// trainer and sharded frame assembly need, with the same C interface and
// the same arithmetic, so that one seed gives the same batches bit for bit:
//   1. a background ray-batch sampler: a producer thread pre-assembles
//      shuffled (origin, direction, rgb) training batches from host-resident
//      images (xorshift64*, the reference camera model) into a bounded queue
//      while the card trains;
//   2. tile assembly: stitch row-contiguous ray tiles into one frame.
// The PNG decoder of the JAX runtime (libpng) is not part of it.
//
// A plain C ABI bound with ctypes (nerf_tpu_torch/runtime/__init__.py),
// built there with g++ -O3 -fPIC -std=c++17 -pthread -shared.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. Background ray-batch sampler
// ---------------------------------------------------------------------------

struct RayBatch {
  std::vector<float> rays_o, rays_d, rgb;  // [n_rays,3] each
};

struct Sampler {
  // dataset (host-resident, borrowed pointers copied in)
  std::vector<float> images;  // [n, H, W, 3]
  std::vector<float> poses;   // [n, 4, 4] row-major camera-to-world
  uint32_t n_images, H, W;
  float focal;
  uint32_t n_rays;
  uint64_t rng;

  // double-buffered producer/consumer queue
  std::queue<RayBatch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  std::thread producer;
  size_t max_queue = 4;

  uint64_t next_rand() {  // xorshift64*
    rng ^= rng >> 12; rng ^= rng << 25; rng ^= rng >> 27;
    return rng * 0x2545F4914F6CDD1DULL;
  }

  void fill(RayBatch* b) {
    uint32_t img = (uint32_t)(next_rand() % n_images);
    const float* P = poses.data() + size_t(img) * 16;
    const float* I = images.data() + size_t(img) * H * W * 3;
    b->rays_o.resize(size_t(n_rays) * 3);
    b->rays_d.resize(size_t(n_rays) * 3);
    b->rgb.resize(size_t(n_rays) * 3);
    for (uint32_t k = 0; k < n_rays; k++) {
      uint64_t pix = next_rand() % (uint64_t(H) * W);
      uint32_t j = (uint32_t)(pix / W), i = (uint32_t)(pix % W);
      // camera-frame direction, reference convention
      // (base_renderer.py:246-251): ((i - W/2)/f, -(j - H/2)/f, -1)
      float dc[3] = {(i - W * 0.5f) / focal, -(j - H * 0.5f) / focal, -1.f};
      for (int r = 0; r < 3; r++) {
        b->rays_d[k * 3 + r] =
            dc[0] * P[r * 4 + 0] + dc[1] * P[r * 4 + 1] + dc[2] * P[r * 4 + 2];
        b->rays_o[k * 3 + r] = P[r * 4 + 3];
        b->rgb[k * 3 + r] = I[(size_t(j) * W + i) * 3 + r];
      }
    }
  }

  void run() {
    for (;;) {
      RayBatch* b = new RayBatch();
      fill(b);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) { delete b; return; }
      ready.push(b);
      cv_ready.notify_one();
    }
  }
};

void* nerf_sampler_create(const float* images, const float* poses,
                          uint32_t n_images, uint32_t height, uint32_t width,
                          float focal, uint32_t n_rays, uint64_t seed) {
  auto* s = new Sampler();
  s->images.assign(images, images + size_t(n_images) * height * width * 3);
  s->poses.assign(poses, poses + size_t(n_images) * 16);
  s->n_images = n_images;
  s->H = height;
  s->W = width;
  s->focal = focal;
  s->n_rays = n_rays;
  s->rng = seed ? seed : 0x9E3779B97F4A7C15ULL;
  s->producer = std::thread([s] { s->run(); });
  return s;
}

// Blocks until a pre-assembled batch is available; copies into caller arrays.
void nerf_sampler_next(void* handle, float* rays_o, float* rays_d, float* rgb) {
  auto* s = (Sampler*)handle;
  RayBatch* b;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_ready.wait(lk, [&] { return !s->ready.empty(); });
    b = s->ready.front();
    s->ready.pop();
    s->cv_space.notify_one();
  }
  size_t n = size_t(s->n_rays) * 3;
  memcpy(rays_o, b->rays_o.data(), n * sizeof(float));
  memcpy(rays_d, b->rays_d.data(), n * sizeof(float));
  memcpy(rgb, b->rgb.data(), n * sizeof(float));
  delete b;
}

void nerf_sampler_destroy(void* handle) {
  auto* s = (Sampler*)handle;
  s->stop.store(true);
  s->cv_space.notify_all();
  s->producer.join();
  while (!s->ready.empty()) { delete s->ready.front(); s->ready.pop(); }
  delete s;
}

// ---------------------------------------------------------------------------
// 2. Tile assembly (sharded-render image stitching)
// ---------------------------------------------------------------------------

// Scatter n_tiles row-contiguous ray tiles back into a [H, W, C] frame.
// offsets/lengths are in rays (pixels); tiles is the concatenated tile data.
void nerf_assemble_tiles(const float* tiles, const uint64_t* offsets,
                         const uint64_t* lengths, uint32_t n_tiles,
                         float* frame, uint64_t frame_rays, uint32_t channels) {
  // (a tile that would end past the frame is skipped; unlike the JAX
  // runtime's loop, the tiles after it are still read from their own data)
  const float* src = tiles;
  for (uint32_t t = 0; t < n_tiles; t++) {
    uint64_t off = offsets[t], len = lengths[t];
    if (off + len <= frame_rays)
      memcpy(frame + off * channels, src, size_t(len) * channels * sizeof(float));
    src += len * channels;
  }
}

}  // extern "C"
