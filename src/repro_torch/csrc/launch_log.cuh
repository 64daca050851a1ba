// Every kernel launch of a library goes through rt::launch, which notes
// its grid, block and dynamic shared memory before launching: the numbers
// the launch itself uses.  launch_log_read hands them to the host
// (repro_torch.analysis.registry, whose CHK-SMEM check holds the shared
// memory against the card's opt-in limit) and starts the log afresh.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <utility>

namespace rt {

constexpr int LAUNCH_LOG_MAX = 64;
// grid x, y, z, block x, y, z, dynamic shared memory bytes
inline unsigned long long g_launch_log[LAUNCH_LOG_MAX][7];
inline int g_launch_count = 0;
// the count saturates here: a process that never reads its log launches
// on
constexpr int LAUNCH_COUNT_MAX = 0x7fffffff;

// Launch `kernel` on `st` with its arguments, noting the configuration.
template <typename Kernel, typename... Args>
inline void launch(Kernel kernel, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t st, Args&&... args) {
  if (g_launch_count < LAUNCH_LOG_MAX) {
    unsigned long long* r = g_launch_log[g_launch_count];
    r[0] = grid.x; r[1] = grid.y; r[2] = grid.z;
    r[3] = block.x; r[4] = block.y; r[5] = block.z;
    r[6] = smem;
  }
  if (g_launch_count < LAUNCH_COUNT_MAX) ++g_launch_count;
  kernel<<<grid, block, smem, st>>>(std::forward<Args>(args)...);
}

}  // namespace rt

// Copy up to max_records launches noted since the last read into out (7
// values each, in launch order), clear the log, and return the number of
// launches noted (which may exceed max_records or LAUNCH_LOG_MAX).
extern "C" int launch_log_read(unsigned long long* out, int max_records) {
  const int n = rt::g_launch_count;
  const int kept = n < rt::LAUNCH_LOG_MAX ? n : rt::LAUNCH_LOG_MAX;
  for (int i = 0; i < kept && i < max_records; ++i)
    for (int j = 0; j < 7; ++j) out[i * 7 + j] = rt::g_launch_log[i][j];
  rt::g_launch_count = 0;
  return n;
}
